"""Training (counterpart of ``tpuvae.train``): train state, objectives, the
per-epoch ``fit`` loop and checkpoints.  The JAX package's
``adam_with_adjustable_lr`` (an optax chain) is the ``torch.optim.Adam``
that :func:`state.create_state` builds, its rate set by
:func:`state.set_learning_rate`."""

from tpuvae_torch.train.state import (  # noqa: F401
    TrainState,
    create_state,
    set_learning_rate,
    get_learning_rate,
    param_count,
)
from tpuvae_torch.train.loop import FitConfig, FitResult, fit, train_val_split  # noqa: F401
from tpuvae_torch.train.objectives import (  # noqa: F401
    simple_vae_objective,
    cvae_objective,
    hybrid_objective,
    autoencoder_objective,
)
from tpuvae_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_train_state_dir,
    save_checkpoint,
    load_checkpoint,
    save_train_state,
    restore_train_state,
)
