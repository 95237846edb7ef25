"""Plain float32 PyTorch references of the model families; they import
nothing of the program."""
