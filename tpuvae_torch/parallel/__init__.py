"""The mesh over ``torch.distributed`` (counterpart of ``tpuvae.parallel``):
one rank per device, a ``DeviceMesh`` with the JAX axis names, DTensor
placements for sharded arrays, the data-parallel step and epoch, and the
tensor-parallel rule for the wide layers."""

from tpuvae_torch.parallel.mesh import (  # noqa: F401
    MeshContext,
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    pad_to_multiple,
    all_gather_latents,
    maybe_init_distributed,
)
from tpuvae_torch.parallel.dp import (  # noqa: F401
    make_dp_epoch,
    make_dp_train_step,
)
from tpuvae_torch.parallel.tp import (  # noqa: F401
    make_tp_dp_train_step,
    tp_spec_for,
    tp_state_sharding,
)
