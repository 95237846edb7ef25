#!/usr/bin/env python3
"""Find the op that puts the bf16 Hybrid VAE's largest error on the card.

``chip_smoke.py`` holds a full-width bf16 forward on the card against the
same forward on the CPU, with the fp32 model on the card as the yardstick
(the contract of ``tests/test_torch_bf16.py``).  This script repeats that
comparison module by module.  It trains a bf16 bundle as
``chip_smoke.py`` does (a seeded corpus of 192 clips of 30 s,
``preprocess_advanced`` with ``stft_method=pallas``, ``run_hybrid_vae`` at
``compute_dtype="bfloat16"``, 3 epochs, batch 32), then runs its forward
on 4 clips in eval and training mode three times, each with a hook on
every leaf module (``Dense``, the stride-2 convs, BatchNorm): bf16 on the
card, bf16 on the CPU, fp32 on the card.  For each module, in call order:

* ``propagated``: the card's largest and L2 distance to the CPU as ratios
  of fp32's distance to the CPU (the contract's ratios, here per module);
* ``isolated``: the module alone on the card fed the CPU's input to it,
  against the CPU's output: the share of elements that differ, the
  largest difference in bf16 ulps of the output, and the largest
  difference over the module's rounding contract, one bf16 ulp at each
  rounding point taken at the magnitude of its terms: ``ulp(product) +
  ulp(output)`` for ``Dense`` and the convs (the product is the output
  less the bias; where they cancel, one ulp of the product is many of the
  output), ``ulp(terms) + ulp(output)`` for BatchNorm, whose float32
  statistics and affine map are rounded once (terms: ``x * s``,
  ``mean * s`` and the output, ``s = scale / sqrt(var + eps)``).  A
  ratio of at most 1 is a module that differs only by the order of its
  float32 sums.

Run on a machine with an NVIDIA GPU from the root of a checkout::

    python3 tools/bf16_op_trace.py [trace.json]

It writes the whole trace as JSON to the path given (default
``build/bf16_op_trace.json``) and prints the summary, the card's name and
power limit first.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SR, DURATION, SEED = 22050, 30.0, 1234
LEAVES = ("Dense", "Stride2Conv", "Stride2ConvTranspose", "BatchNorm1d",
          "BatchNorm2d")
OUTPUTS = ("recon_audio", "recon_text", "mu", "logvar")


def ulp(x: np.ndarray) -> np.ndarray:
    """bfloat16's spacing at |x|."""
    a = np.abs(np.asarray(x, np.float32))
    _, e = np.frexp(a)
    return np.ldexp(1.0, np.where(a == 0, -125, e) - 8)


def ratios(card, cpu, fp32) -> dict:
    """The contract's ratios: the card's distance to the CPU over fp32's,
    largest element and L2, both relative to the fp32 output."""
    card, cpu, fp32 = (np.asarray(a, np.float64) for a in (card, cpu, fp32))
    d_max, s_max = np.abs(card - cpu).max(), np.abs(cpu - fp32).max()
    d_l2, s_l2 = np.linalg.norm(card - cpu), np.linalg.norm(cpu - fp32)
    return {"max": float(d_max / s_max) if s_max else None,
            "l2": float(d_l2 / s_l2) if s_l2 else None,
            "max_share": float(d_max / np.abs(fp32).max()),
            "spread_max_share": float(s_max / np.abs(fp32).max()),
            "argmax": [int(i) for i in np.unravel_index(
                np.abs(card - cpu).argmax(), card.shape)]}


def contract_bound(torch, mod, x, want: np.ndarray, train: bool):
    """One bf16 ulp at each rounding point of ``mod`` on input ``x`` (the
    CPU's), at the magnitude of the terms, for the CPU's output ``want``."""
    big = np.abs(want)
    kind = type(mod).__name__
    if kind.startswith("BatchNorm"):
        xf = x.float()
        dims = (0,) if xf.dim() == 2 else (0, 2, 3)
        shape = (1, -1) + (1,) * (xf.dim() - 2)
        if train:
            mean = xf.mean(dim=dims)
            var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
        else:
            mean, var = mod.running_mean.cpu(), mod.running_var.cpu()
        s = (mod.weight.detach().cpu() * torch.rsqrt(var + mod.eps)).view(shape)
        terms = torch.maximum((xf * s).abs(), (mean.view(shape) * s).abs())
        terms = np.maximum(terms.numpy(), big)
        return ulp(terms) + ulp(big)
    bias = mod.bias.detach().cpu().bfloat16().float().numpy()
    if kind != "Dense":
        bias = bias.reshape(1, -1, 1, 1)
    return ulp(np.maximum(big, np.abs(want - bias))) + ulp(big)


def traced_forward(torch, model, inputs, eps, where, train: bool):
    """The model's outputs and every leaf module's (input, output), in
    call order, as host tensors (inputs in their own dtype)."""
    model = copy.deepcopy(model).to(where).train(train)
    calls = []

    def hook(name):
        def record(mod, args, out):
            calls.append((name, args[0].detach().cpu(),
                          out.detach().float().cpu()))
        return record

    for name, mod in model.named_modules():
        if type(mod).__name__ in LEAVES:
            mod.register_forward_hook(hook(name))
    with torch.no_grad():
        outs = model(*[torch.from_numpy(a).to(where) for a in inputs],
                     eps.to(where))
    return [o.float().cpu().numpy() for o in outs], calls, model


def trace(torch, models, inputs, eps, dev, train: bool) -> dict:
    card, card_calls, card_model = traced_forward(
        torch, models["bf16"], inputs, eps, dev, train)
    cpu, cpu_calls, cpu_model = traced_forward(torch, models["bf16"], inputs,
                                               eps, "cpu", train)
    modules_cpu = dict(cpu_model.named_modules())
    f32, f32_calls, _ = traced_forward(torch, models["fp32"], inputs, eps,
                                       dev, train)
    modules = dict(card_model.named_modules())
    # fp32 runs trunk layers 0-1 inside kernel 6, not as modules
    f32_out = {name: out for name, _, out in f32_calls}
    rows = []
    for (name, _, c_out), (_, p_in, p_out) in zip(card_calls, cpu_calls):
        mod = copy.deepcopy(modules[name]).train(train)
        with torch.no_grad():
            alone = mod(p_in.to(dev)).float().cpu().numpy()
        want = p_out.numpy()
        diff = np.abs(alone - want)
        big = np.maximum(np.abs(alone), np.abs(want))
        bound = contract_bound(torch, modules_cpu[name], p_in, want, train)
        rows.append({
            "module": name, "kind": type(mod).__name__,
            "shape": list(want.shape),
            "propagated": (ratios(c_out.numpy(), want, f32_out[name].numpy())
                           if name in f32_out else None),
            "isolated": {"differ_share": float(np.mean(diff > 0)),
                         "max_ulps": float((diff / ulp(big)).max()),
                         "max_over_contract": float((diff / bound).max())}})
    return {"outputs": {nm: ratios(c, p, f) for nm, c, p, f in
                        zip(OUTPUTS, card, cpu, f32)},
            "modules": rows}


def main(out: Path) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bf16_op_trace: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from tpuvae_torch.config import (
        AdvancedPreprocessConfig,
        ClusterConfig,
        HybridVAEConfig,
    )
    from tpuvae_torch.convert import from_flax
    from tpuvae_torch.device import resolve_device
    from tpuvae_torch.infer import _build_model
    from tpuvae_torch.io.artifacts import load_advanced
    from tpuvae_torch.io.synthetic import generate_dataset
    from tpuvae_torch.ops import _build
    from tpuvae_torch.pipelines import preprocess_advanced, run_hybrid_vae
    from tpuvae_torch.train.checkpoint import load_checkpoint
    from tpuvae_torch.utils.logging import RunLogger

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = resolve_device("cuda")
    _build.build_all()
    work = ROOT / "build" / "bf16_op_trace"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    meta_csv = generate_dataset(work / "Datasets", clips_per_genre_lang=32,
                                sr=SR, duration=DURATION, seed=SEED)
    data2 = work / "processed_data2"
    logger = RunLogger(work / "run.jsonl", echo=False)
    preprocess_advanced(AdvancedPreprocessConfig(
        sample_rate=SR, duration=DURATION, dataset_root=str(work / "Datasets"),
        metadata_csv=str(meta_csv), extract_batch=128, stft_method="pallas",
        output_dir=str(data2)), device="cuda", logger=logger)
    results = work / "results"
    run_hybrid_vae(str(data2), str(results),
                   HybridVAEConfig(epochs=3, batch_size=32,
                                   compute_dtype="bfloat16"),
                   ClusterConfig(), logger, make_plots=False, device="cuda")
    logger.close()
    print(f"bundle trained in {time.perf_counter() - t0:.1f} s", flush=True)

    flat, meta = load_checkpoint(results / "Convolutional_VAE" / "serving"
                                 / "model")
    data = load_advanced(data2)
    inputs = [np.asarray(data["mel"][:4], np.float32)[..., None],
              np.asarray(data["text"][:4], np.float32)]
    eps = torch.randn((4, meta["latent_dim"]),
                      generator=torch.Generator().manual_seed(SEED))
    models = {}
    for tag, dt in (("bf16", "bfloat16"), ("fp32", "float32")):
        models[tag] = _build_model("hybrid", {**meta, "compute_dtype": dt})
        models[tag].load_state_dict(from_flax(flat))
    report = {"card": card}
    for mode in ("eval", "train"):
        report[mode] = trace(torch, models, inputs, eps, dev, mode == "train")
        print(f"{mode} outputs: " + json.dumps(report[mode]["outputs"]),
              flush=True)
        for row in report[mode]["modules"]:
            p, i = row["propagated"] or {}, row["isolated"]
            print(f"  {mode} {row['module']:32s} {row['kind']:20s} "
                  f"prop max {p.get('max')} l2 {p.get('l2')} | alone: differ "
                  f"{i['differ_share']:.2e}, max {i['max_ulps']:.2f} ulp, "
                  f"{i['max_over_contract']:.3f} x contract",
                  flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"trace written to {out}; card: {card}")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("TPUVAE_LOADER_THREADS", "8")
    sys.exit(main(Path(sys.argv[1]) if len(sys.argv) > 1
                  else ROOT / "build" / "bf16_op_trace.json"))
