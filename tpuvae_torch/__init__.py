"""tpuvae_torch — the PyTorch/CUDA port of ``tpuvae`` for NVIDIA Hopper.

The JAX package ``tpuvae`` stays the reference; this package re-implements
its serving path for the ``simple`` architecture on one H100, with every
Pallas kernel on that path replaced by a CUDA C++ kernel for ``sm_90a``
(``tpuvae_torch/csrc``) and a plain PyTorch version of the same function
beside it.  It imports neither JAX nor anything of ``tpuvae``.

Layers, mirroring ``tpuvae/``:
  config.py   PreprocessConfig (own copy)
  device.py   device resolution: CUDA by default, never a silent CPU run
  io/         WAV decode + resample, MeanImputer / StandardScaler
  dsp/        batched feature extraction (370-d vector), chroma + tuning
  ops/        the CUDA kernels, their ctypes binding and plain versions
  models/     SimpleVAE as an ``nn.Module``
  convert.py  flax ``weights.npz`` <-> the port's ``state_dict``
  train/      ``load_checkpoint`` (npz + json)
  infer.py    ClipEncoder: raw clips -> latents + nearest centroid
  serve.py    HTTP daemon around infer (stdlib-only JSON API)
  cli.py      ``encode`` and ``serve``
"""

__version__ = "0.1.0"
