"""Small shared utilities: batching, run logging and stage timers.  The
JAX package's ``enable_compilation_cache`` (the XLA cache) has no
counterpart: the kernels' hashed build directory (``ops/_build.py``) is
the port's cache."""

from tpuvae_torch.utils.batching import RowView, batched_apply  # noqa: F401
from tpuvae_torch.utils.logging import RunLogger, StageTimer  # noqa: F401
