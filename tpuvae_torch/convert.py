"""Carry SimpleVAE weights between the flax layout and the port.

``weights.npz`` (``tpuvae/train/checkpoint.py:32-35``) stores the flax
variables flattened to ``"params/..."`` / ``"batch_stats/..."`` keys.  The
map to the port's ``state_dict``:

* Dense ``kernel (in, out)`` -> Linear ``weight (out, in)``, ``bias`` as is;
* BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
  ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  (flax's var is the biased running variance; copied as is).
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

_MLP = re.compile(r"(encoder|decoder)/(Dense|BatchNorm)_(\d+)$")


def _module_name(flax_path: str) -> tuple[str, str]:
    """flax module path -> (port module name, kind in {'dense', 'norm'})."""
    m = _MLP.match(flax_path)
    if m:
        block, kind, i = m.groups()
        kind = "dense" if kind == "Dense" else "norm"
        return f"{block}.{kind}.{i}", kind
    if flax_path in ("fc_mu", "fc_logvar", "out"):
        return flax_path, "dense"
    raise KeyError(f"no SimpleVAE counterpart for flax module {flax_path!r}")


_PARAM_NAMES = {
    ("params", "dense", "kernel"): "weight",
    ("params", "dense", "bias"): "bias",
    ("params", "norm", "scale"): "weight",
    ("params", "norm", "bias"): "bias",
    ("batch_stats", "norm", "mean"): "running_mean",
    ("batch_stats", "norm", "var"): "running_var",
}


def simple_vae_from_flax(flat: dict) -> "OrderedDict[str, torch.Tensor]":
    """flax ``weights.npz`` contents -> the port's SimpleVAE ``state_dict``."""
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    for key, value in flat.items():
        coll, *path, leaf = key.split("/")
        module, kind = _module_name("/".join(path))
        name = _PARAM_NAMES.get((coll, kind, leaf))
        if name is None:
            raise KeyError(f"unexpected flax variable {key!r}")
        arr = np.array(value, dtype=np.float32)
        if name == "weight" and kind == "dense":
            arr = arr.T
        out[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
        if name == "running_var":
            out[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return out


def simple_vae_to_flax(state_dict) -> dict[str, np.ndarray]:
    """The port's SimpleVAE ``state_dict`` -> flax ``weights.npz`` contents."""
    out = {}
    for name, tensor in state_dict.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        parts = module.split(".")
        if len(parts) == 3:
            block, kind, i = parts
            flax_path = (f"{block}/{'Dense' if kind == 'dense' else 'BatchNorm'}"
                         f"_{i}")
        else:
            kind, flax_path = "dense", module
        coll, flax_leaf = next(
            ((c, fl) for (c, k, fl), v in _PARAM_NAMES.items()
             if v == leaf and k == kind), (None, None))
        if coll is None:
            raise KeyError(f"unexpected state_dict entry {name!r}")
        arr = tensor.detach().cpu().numpy().astype(np.float32)
        if kind == "dense" and leaf == "weight":
            arr = arr.T
        out[f"{coll}/{flax_path}/{flax_leaf}"] = np.ascontiguousarray(arr)
    return out
