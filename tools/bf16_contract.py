#!/usr/bin/env python3
"""Measure the bf16 contract of ``tests/test_torch_bf16.py`` on the CPU.

Prints, for the port's bf16 layers and models against the JAX package's
flax modules at ``dtype=jnp.bfloat16`` (op by op), on the test file's own
inputs, weights and noise:

* Dense and the stride-2 convs: the share of elements that differ and
  the largest error in units of one ulp at each rounding point;
* each model output in eval and train mode: the port's relative L2 and
  largest-element errors as ratios of flax fp32's distance to flax bf16;
* the loss: both distances relative to the loss;
* the gradient: the whole gradient's relative L2 ratio and the largest
  per-tensor ratio.

Run from the root of a checkout with JAX on the CPU (no card needed)::

    JAX_PLATFORMS=cpu python tools/bf16_contract.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import test_torch_bf16 as t  # noqa: E402


def layers() -> None:
    rng = np.random.default_rng(0)
    cases = {"dense": [t._dense_case(a, b, rng) for a, b in
                       ((768, 256), (2048, 64), (512, 1152))]}
    for layer, kind in (("conv", "conv"), ("conv_transpose", "convT")):
        cases[layer] = [t._conv_case(kind, *c, rng) for c in
                        ((1, 32, (64, 128)), (32, 64, (32, 64)),
                         (256, 512, (4, 8)))]
    for layer, runs in cases.items():
        for got, want, bias in runs:
            big = np.maximum(np.abs(got), np.abs(want))
            bound = t._ulp(np.maximum(big, np.abs(want - bias))) + t._ulp(big)
            err = np.abs(got - want)
            print(f"{layer} {got.shape}: differ {np.mean(err > 0):.2e}, "
                  f"largest error / bound {float((err / bound).max()):.3f}")


def models() -> None:
    import tpuvae_torch.models as pmodels
    from tpuvae_torch.convert import to_flax

    for kind in ("simple", "cvae", "hybrid"):
        ref = t.flax_outputs(kind)
        for mode in ("eval", "train"):
            _, _, outs = t._port_forward(kind, mode == "train")
            for i, got in enumerate(outs):
                p = t._rel(got.detach().float().numpy(), ref["bf16"][mode][i],
                           ref["f32"][mode][i])
                s = t._rel(ref["bf16"][mode][i], ref["f32"][mode][i],
                           ref["f32"][mode][i])
                print(f"{kind} {mode} output {i}: L2 ratio "
                      f"{p[1] / s[1]:.3f}, max ratio {p[0] / s[0]:.3f}")
        model, tin, outs = t._port_forward(kind, True)
        loss = t._loss(kind, outs, tin, pmodels)
        loss.backward()
        l16, l32 = ref["bf16"]["loss"], ref["f32"]["loss"]
        print(f"{kind} loss: port {abs(float(loss.detach()) - l16) / l16:.2e}, "
              f"flax fp32 {abs(l32 - l16) / l16:.2e} of the loss")
        got = to_flax({n: q.grad for n, q in model.named_parameters()})
        w16, w32 = ref["bf16"]["grad"], ref["f32"]["grad"]
        p2 = sum(float(np.sum((got[k] - w16[k].astype(np.float64)) ** 2))
                 for k in got)
        s2 = sum(float(np.sum((w16[k] - w32[k].astype(np.float64)) ** 2))
                 for k in got)
        worst = max((float(np.linalg.norm(got[k] - w16[k]))
                     / max(float(np.linalg.norm(w16[k] - w32[k])), 1e-30), k)
                    for k in got)
        print(f"{kind} gradient: whole L2 ratio {(p2 / s2) ** 0.5:.3f}; "
              f"largest tensor ratio {worst[0]:.3f} ({worst[1]})")


if __name__ == "__main__":
    layers()
    models()
