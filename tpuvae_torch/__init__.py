"""tpuvae_torch — the PyTorch/CUDA port of ``tpuvae`` for NVIDIA Hopper.

The JAX package ``tpuvae`` stays the reference; this package re-implements
its input front end (WAV / FLAC / MP3 decode, the native C++ loader, the
XLM-R lyrics encoder), its preprocess pipelines, the Simple, Conditional
and Hybrid VAE training pipelines and serving on one H100, with
every Pallas kernel on those paths replaced by a CUDA C++ kernel for
``sm_90a`` (``tpuvae_torch/csrc``) and a plain PyTorch version of the same
function beside it.  It imports neither JAX nor anything of ``tpuvae``.

Layers, mirroring ``tpuvae/``:
  config.py     the preprocess, VAE and cluster configs (own copies)
  device.py     device resolution: CUDA by default, never a silent CPU run
  io/           audio decode + resample (native C++ loader built from
                ``native/`` with g++; Python WAV, FLAC, MP3), the synthetic
                corpus, MeanImputer / StandardScaler, the artifacts, the
                consolidated metrics CSV
  text/         lyrics embeddings: hashed n-grams, or the XLM-R sentence
                encoder (tokenizer, ``nn.Module``s) from a checkpoint
  dsp/          batched feature extraction (370-d vector), chroma + tuning
  ops/          the CUDA kernels, their ctypes binding and plain versions
  models/       SimpleVAE, ConditionalVAE, HybridVAE and the autoencoder
                baseline as ``nn.Module``s (flax's BatchNorm and init; the
                conv trunk's first two layers through kernel 6)
  metrics/      labels, pairwise distances (kernel 5), silhouette / DB / CH,
                NMI / ARI / purity
  cluster/      k-means, Ward, DBSCAN, spectral, the three sweeps, PCA
  train/        train state (Adam), objectives, the fit loop, checkpoints
  convert.py    flax ``weights.npz`` <-> the port's ``state_dict``; the
                flax sentence encoder's params <-> the port's
  pipelines.py  preprocess_basic / preprocess_advanced; run_simple_vae,
                run_conditional_vae and run_hybrid_vae: train, cluster,
                metrics CSV, bundle
  infer.py      ClipEncoder: raw clips -> latents + nearest centroid
  serve.py      HTTP daemon around infer (stdlib-only JSON API)
  cli.py        ``synth-data``, ``preprocess``, ``preprocess-advanced``,
                ``train-simple``, ``train-cvae``, ``train-hybrid``,
                ``encode`` and ``serve``
"""

__version__ = "0.1.0"
