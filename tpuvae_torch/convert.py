"""Carry model weights between the flax layout and the port.

``weights.npz`` (``tpuvae/train/checkpoint.py:32-35``) stores the flax
variables flattened to ``"params/..."`` / ``"batch_stats/..."`` keys.  The
map to the port's ``state_dict``, for ``SimpleVAE``, ``ConditionalVAE``,
``HybridVAE`` and ``SimpleAutoencoder`` alike:

* Dense ``kernel (in, out)`` -> Linear ``weight (out, in)``, ``bias`` as is;
* BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
  ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
  (flax's var is the biased running variance; copied as is);
* Conv ``kernel`` HWIO ``(3, 3, C, F)`` -> ``Stride2Conv.weight (F, C, 3, 3)``;
* ConvTranspose ``kernel (3, 3, C, F)`` -> ``Stride2ConvTranspose.weight
  (C, F, 3, 3)``, flipped on both spatial axes (``lax.conv_transpose`` does
  not flip its kernel, ``conv_transpose2d`` does).

Module names: flax's auto-named ``<block>/Dense_i``, ``BatchNorm_i``,
``Conv_i`` and ``ConvTranspose_i`` are the port's ``<block>.dense.i``,
``<block>.norm.i`` and ``<block>.conv.i`` (``ModuleList``s); named modules
(``fc_mu``, ``text_bn``, ...) keep their names.  No Linear weight is
permuted beyond its transpose: the port keeps NHWC at its modules' borders,
so the trunks flatten in flax's (H, W, C) order.

The lyrics encoder (``tpuvae_torch.text.encoder.SentenceEncoder``) carries
across from the flax ``SentenceEncoder``'s nested ``params`` with
:func:`encoder_from_flax` / :func:`encoder_to_flax`: Embed ``embedding``
-> ``weight``; LayerNorm ``scale`` -> ``weight``; Dense ``kernel (in, out)``
-> ``weight (out, in)``; the attention's q / k / v ``kernel (h, heads,
head_dim)`` and ``bias (heads, head_dim)`` -> ``(h, h)`` / ``(h,)``, its
``out`` ``kernel (heads, head_dim, h)`` -> ``(h, h)``; ``layer_<i>`` ->
``layers.<i>``.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

_INDEXED = re.compile(r"(?:(.+)/)?(Dense|BatchNorm|Conv|ConvTranspose)_(\d+)$")
_INDEXED_KINDS = {"Dense": ("dense", "dense"), "BatchNorm": ("norm", "norm"),
                  "Conv": ("conv", "conv"), "ConvTranspose": ("conv", "convt")}
# named flax modules of the four models -> kind
_NAMED = {
    **{n: "dense" for n in (
        "fc_mu", "fc_logvar", "out", "text_fc", "decoder_fc", "text_dec_fc1",
        "text_dec_fc2", "audio_fc", "text_fc1", "text_fc2", "fc_fusion",
        "decoder_input", "decoder_split", "audio_decoder_fc")},
    **{n: "norm" for n in ("text_bn", "text_dec_bn", "text_bn1", "text_bn2")},
}

_PARAM_NAMES = {
    ("params", "dense", "kernel"): "weight",
    ("params", "dense", "bias"): "bias",
    ("params", "conv", "kernel"): "weight",
    ("params", "conv", "bias"): "bias",
    ("params", "convt", "kernel"): "weight",
    ("params", "convt", "bias"): "bias",
    ("params", "norm", "scale"): "weight",
    ("params", "norm", "bias"): "bias",
    ("batch_stats", "norm", "mean"): "running_mean",
    ("batch_stats", "norm", "var"): "running_var",
}


def _module_name(flax_path: str) -> tuple[str, str]:
    """flax module path -> (port module name, kind)."""
    m = _INDEXED.match(flax_path)
    if m:
        block, flax_kind, i = m.groups()
        word, kind = _INDEXED_KINDS[flax_kind]
        prefix = block.replace("/", ".") + "." if block else ""
        return f"{prefix}{word}.{i}", kind
    if flax_path in _NAMED:
        return flax_path, _NAMED[flax_path]
    raise KeyError(f"no counterpart in the port for flax module {flax_path!r}")


def _flax_path(module: str) -> tuple[str, str]:
    """Port module name -> (flax module path, kind)."""
    parts = module.split(".")
    if len(parts) >= 2 and parts[-1].isdigit():
        *block, word, i = parts
        if word == "conv":
            transposed = bool(block) and block[-1].endswith("decoder")
            flax_kind, kind = (("ConvTranspose", "convt") if transposed
                               else ("Conv", "conv"))
        elif word in ("dense", "norm"):
            flax_kind, kind = (("Dense", "dense") if word == "dense"
                               else ("BatchNorm", "norm"))
        else:
            raise KeyError(f"unexpected module list {module!r}")
        return "/".join([*block, f"{flax_kind}_{i}"]), kind
    if module in _NAMED:
        return module, _NAMED[module]
    raise KeyError(f"no flax counterpart for module {module!r}")


def _to_port(arr: np.ndarray, kind: str, name: str) -> np.ndarray:
    if name != "weight":
        return arr
    if kind == "dense":
        return arr.T
    if kind == "conv":                       # HWIO -> OIHW
        return arr.transpose(3, 2, 0, 1)
    if kind == "convt":                      # HWIO, flipped -> (I, O, H, W)
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr


def _to_flax(arr: np.ndarray, kind: str, name: str) -> np.ndarray:
    if name != "weight":
        return arr
    if kind == "dense":
        return arr.T
    if kind == "conv":
        return arr.transpose(2, 3, 1, 0)
    if kind == "convt":
        return arr.transpose(2, 3, 0, 1)[::-1, ::-1]
    return arr


def from_flax(flat: dict) -> "OrderedDict[str, torch.Tensor]":
    """flax ``weights.npz`` contents -> the port's ``state_dict`` (any of
    the four models)."""
    out: OrderedDict[str, torch.Tensor] = OrderedDict()
    for key, value in flat.items():
        coll, *path, leaf = key.split("/")
        module, kind = _module_name("/".join(path))
        name = _PARAM_NAMES.get((coll, kind, leaf))
        if name is None:
            raise KeyError(f"unexpected flax variable {key!r}")
        arr = _to_port(np.array(value, dtype=np.float32), kind, name)
        out[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
        if name == "running_var":
            out[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return out


def to_flax(state_dict) -> dict[str, np.ndarray]:
    """The port's ``state_dict`` (or any dict keyed like it: parameters,
    gradients) -> flax ``weights.npz`` contents."""
    out = {}
    for name, tensor in state_dict.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        flax_path, kind = _flax_path(module)
        coll, flax_leaf = next(
            ((c, fl) for (c, k, fl), v in _PARAM_NAMES.items()
             if v == leaf and k == kind), (None, None))
        if coll is None:
            raise KeyError(f"unexpected state_dict entry {name!r}")
        arr = _to_flax(tensor.detach().cpu().numpy().astype(np.float32),
                       kind, leaf)
        out[f"{coll}/{flax_path}/{flax_leaf}"] = np.ascontiguousarray(arr)
    return out


# the names the SimpleVAE callers use: the same maps
simple_vae_from_flax = from_flax
simple_vae_to_flax = to_flax


# -- the lyrics encoder ---------------------------------------------------------

_ENC_EMBEDS = ("word_emb", "pos_emb", "type_emb")
_ENC_QKV = ("query", "key", "value")


def encoder_from_flax(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """flax ``SentenceEncoder`` variables (``{"params": {...}}`` or the
    params alone) -> the port's ``SentenceEncoder`` ``state_dict``."""
    params = variables.get("params", variables)
    out: OrderedDict[str, torch.Tensor] = OrderedDict()

    def put(name, arr):
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32,
                                              order="C"))

    for name in _ENC_EMBEDS:
        put(f"{name}.weight", params[name]["embedding"])
    put("emb_ln.weight", params["emb_ln"]["scale"])
    put("emb_ln.bias", params["emb_ln"]["bias"])
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        lp, pre = params[f"layer_{i}"], f"layers.{i}."
        att = lp["attention"]
        for name in _ENC_QKV:
            k = np.asarray(att[name]["kernel"])            # (h, heads, hd)
            put(pre + f"attention.{name}.weight", k.reshape(k.shape[0], -1).T)
            put(pre + f"attention.{name}.bias",
                np.asarray(att[name]["bias"]).reshape(-1))
        k = np.asarray(att["out"]["kernel"])               # (heads, hd, h)
        put(pre + "attention.out.weight", k.reshape(-1, k.shape[-1]).T)
        put(pre + "attention.out.bias", att["out"]["bias"])
        for name in ("attn_ln", "ffn_ln"):
            put(pre + f"{name}.weight", lp[name]["scale"])
            put(pre + f"{name}.bias", lp[name]["bias"])
        for name in ("ffn_in", "ffn_out"):
            put(pre + f"{name}.weight", np.asarray(lp[name]["kernel"]).T)
            put(pre + f"{name}.bias", lp[name]["bias"])
    return out


def encoder_to_flax(state_dict, heads: int) -> dict:
    """The port's ``SentenceEncoder`` ``state_dict`` -> flax variables
    ``{"params": {...}}`` (numpy); ``heads`` splits the attention kernels."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in state_dict.items()}
    params: dict = {name: {"embedding": sd[f"{name}.weight"]}
                    for name in _ENC_EMBEDS}
    params["emb_ln"] = {"scale": sd["emb_ln.weight"], "bias": sd["emb_ln.bias"]}
    n_layers = 1 + max((int(k.split(".")[1]) for k in sd
                        if k.startswith("layers.")), default=-1)
    for i in range(n_layers):
        pre = f"layers.{i}."
        h = sd[pre + "attention.query.weight"].shape[0]
        att = {}
        for name in _ENC_QKV:
            w = sd[pre + f"attention.{name}.weight"]
            att[name] = {
                "kernel": np.ascontiguousarray(w.T.reshape(h, heads, h // heads)),
                "bias": sd[pre + f"attention.{name}.bias"].reshape(heads, -1)}
        att["out"] = {
            "kernel": np.ascontiguousarray(
                sd[pre + "attention.out.weight"].T.reshape(heads, h // heads, h)),
            "bias": sd[pre + "attention.out.bias"]}
        layer = {"attention": att}
        for name in ("attn_ln", "ffn_ln"):
            layer[name] = {"scale": sd[pre + f"{name}.weight"],
                           "bias": sd[pre + f"{name}.bias"]}
        for name in ("ffn_in", "ffn_out"):
            layer[name] = {
                "kernel": np.ascontiguousarray(sd[pre + f"{name}.weight"].T),
                "bias": sd[pre + f"{name}.bias"]}
        params[f"layer_{i}"] = layer
    return {"params": params}
