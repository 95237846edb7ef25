"""tpuvae_torch — the PyTorch/CUDA port of ``tpuvae`` for NVIDIA Hopper.

The JAX package ``tpuvae`` stays the reference; this package re-implements
its serving path and its Simple VAE training pipeline on one H100, with
every Pallas kernel on those paths replaced by a CUDA C++ kernel for
``sm_90a`` (``tpuvae_torch/csrc``) and a plain PyTorch version of the same
function beside it.  It imports neither JAX nor anything of ``tpuvae``.

Layers, mirroring ``tpuvae/``:
  config.py     PreprocessConfig, SimpleVAEConfig, ClusterConfig (own copies)
  device.py     device resolution: CUDA by default, never a silent CPU run
  io/           WAV decode + resample, MeanImputer / StandardScaler, the
                processed_data1 artifacts, the consolidated metrics CSV
  dsp/          batched feature extraction (370-d vector), chroma + tuning
  ops/          the CUDA kernels, their ctypes binding and plain versions
  models/       SimpleVAE as an ``nn.Module`` (flax's BatchNorm and init)
  metrics/      labels, pairwise distances (kernel 5), silhouette / DB / CH
  cluster/      k-means, the silhouette k-sweep, PCA
  train/        train state (Adam), objectives, the fit loop, checkpoints
  convert.py    flax ``weights.npz`` <-> the port's ``state_dict``
  pipelines.py  run_simple_vae: train, sweep, metrics CSV, serving bundle
  infer.py      ClipEncoder: raw clips -> latents + nearest centroid
  serve.py      HTTP daemon around infer (stdlib-only JSON API)
  cli.py        ``train-simple``, ``encode`` and ``serve``
"""

__version__ = "0.1.0"
