"""The port's side of each model family: build what the pipeline hands
to ``fit``, and count the work from the shapes."""
