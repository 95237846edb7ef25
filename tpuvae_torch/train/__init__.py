"""Training (counterpart of ``tpuvae.train``): train state, objectives, the
per-epoch ``fit`` loop and checkpoints."""
