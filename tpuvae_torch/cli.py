"""Command-line interface of the PyTorch port (counterpart of the same
commands in ``tpuvae/cli.py``):

  python -m tpuvae_torch.cli synth-data  [--root=Datasets --clips_per_genre_lang=4] [--container=wav|flac|mixed]
  python -m tpuvae_torch.cli preprocess           [--key=value ...]
  python -m tpuvae_torch.cli preprocess-advanced  [--key=value ...]
  python -m tpuvae_torch.cli train-simple [--key=value ...]
  python -m tpuvae_torch.cli train-cvae   [--key=value ...]
  python -m tpuvae_torch.cli train-hybrid [--key=value ...]
  python -m tpuvae_torch.cli encode [--arch=hybrid] song.wav [song2.wav ...]
  python -m tpuvae_torch.cli serve  [--arch=hybrid] --port=8787   # HTTP daemon

``synth-data`` writes a seeded reference-layout corpus with its
``updated_metadata.csv``.  Flags: ``--root`` (default ``Datasets``),
``--clips_per_genre_lang`` (4), ``--seed_data`` (42), ``--separation``
(1.0), ``--container`` (``wav``; ``flac``, or ``mixed`` to alternate the
two by clip).  It touches no device.  Audio decodes through the native C++
loader (built with g++ at first use), FLAC and WAV alike.

``preprocess`` extracts the 370-d features of every catalogued clip into
``processed_data1/``; ``preprocess-advanced`` the mel images, 290-d
features and lyrics embeddings into ``processed_data2/``.  ``--key=value``
overrides map onto ``PreprocessConfig`` / ``AdvancedPreprocessConfig``
(``--duration=2.0``, ``--extract_batch=8``, ``--stft_method=pallas``, ...);
extra flag: ``--device`` (default cuda).  ``stft_method``: ``auto`` =
the fused FFT kernel with the fused tuning kernel; ``pallas`` = the
dense-DFT kernel with the staged tuning route; ``fft`` / ``dft`` = library
FFT / dense matmuls with the staged route.  ``$TPUVAE_TEXT_CHECKPOINT``
(a directory with ``pytorch_model.bin``, an optional ``config.json`` and a
sentencepiece ``*.model``) embeds the lyrics with the XLM-R sentence
encoder on ``--device``; unset, by hashed n-grams.

``train-simple`` trains the Simple VAE on a ``processed_data1`` and writes
``results/clustering_metrics.csv``, ``results/Simple_VAE/best_vae_model/``
and the serving bundle ``results/Simple_VAE/serving/``.  ``--key=value``
overrides map onto ``SimpleVAEConfig`` (values parsed as JSON first, so
``--epochs=5`` is an int).  Extra flags, as in the JAX CLI: ``--data1_dir``,
else ``--data_dir`` (default ``processed_data1``), ``--results_dir``
(default ``results``), ``--data2_dir`` (read by ``train-cvae``) and the
JAX CLI's other shared flags (accepted, unused); a bare extra flag reads as
``1``.  And ``--device`` (default cuda).  Plots are off: the t-SNE figure
of the JAX command is not ported yet.

``train-cvae`` trains the Conditional VAE on a ``processed_data2`` and
writes ``results/clustering_metrics.csv`` (four rows: CVAE, PCA + K-Means,
Autoencoder + K-Means, Direct Spectral), a copy under
``results/Conditional_VAE/`` and the serving bundle
``results/Conditional_VAE/serving/``.  ``--key=value`` overrides map onto
``ConditionalVAEConfig`` (``--epochs=5``, ``--batch_size=8``,
``--host_stream=true`` to keep the mel images on the host); extra flags as
``train-simple``, the data read from ``--data2_dir``, else ``--data_dir``
(default ``processed_data2``).

``train-hybrid`` trains the Hybrid VAE on a ``processed_data2`` and writes
``results/Convolutional_VAE/hybrid_latent_features.npy``,
``results/clustering_metrics.csv`` (four rows: K-Means-Main at the
silhouette-best k in 2..14, K-Means-Language at k = 2, Agglomerative (Ward)
and DBSCAN at their silhouette-best k / eps), a copy under
``results/Convolutional_VAE/`` and the serving bundle
``results/Convolutional_VAE/serving/``.  Overrides map onto
``HybridVAEConfig``; extra flags and data as ``train-cvae``.

``encode`` maps NEW audio clips through a trained model to latents +
nearest-training-centroid cluster ids (the serving bundle of a prior
``train-*`` run).  Flags: ``--arch`` (``hybrid``, the default, ``cvae`` or
``simple``), ``--results_dir``, ``--data_dir`` (preprocessing dir with the
scalers), ``--lyrics=<text>`` (the same lyrics for every clip) or
``--lyrics_file=<file>`` (one line per clip; ``cvae`` / ``hybrid``),
``--genres=a,b,...`` (one per clip; ``cvae``), ``--batch_size``,
``--out=<file.npz>`` to save latents/clusters, ``--device`` (default cuda).
``encode`` and ``serve`` embed lyrics through ``$TPUVAE_TEXT_CHECKPOINT``
as ``preprocess-advanced`` does; a backend other than the bundle's warns.

``serve`` keeps a trained model resident behind a JSON HTTP API
(``GET /healthz``, ``GET /info``, ``POST /encode`` — see
:mod:`tpuvae_torch.serve`).  Flags: ``--arch`` (default ``hybrid``), ``--results_dir``,
``--data_dir``, ``--host`` (default 127.0.0.1), ``--port`` (default 8787),
``--warmup=0|1`` (one silent clip first, default 1), ``--batch_wait_ms``
(>0 micro-batches concurrent requests, default 0 = serialized),
``--max_batch`` (clips per device pass under micro-batching, default 32),
``--device`` (default cuda).

Every command runs on the card; without CUDA it stops with an error unless
``--device=cpu`` is given.
"""

from __future__ import annotations

import sys


def _parse_flags(cmd: str, args, opts: set[str]):
    """``--key=value`` flags (all of ``opts``) and positional arguments."""
    flags, positional = {}, []
    flags_done = False
    for a in args:
        if a == "--":                   # conventional end-of-flags marker
            flags_done = True
        elif not flags_done and a.startswith("-"):
            key, sep, value = a.lstrip("-").partition("=")
            if key not in opts:
                raise KeyError(f"{cmd} has no flag {key!r} "
                               f"(known: {sorted(opts)})")
            if not sep:
                raise ValueError(f"--{key} needs a value: --{key}=...")
            flags[key] = value
        else:
            positional.append(a)
    return flags, positional


# flags every train command of the JAX CLI takes besides its config's
# fields (tpuvae/cli.py:102-104), and the port's own --device
_TRAIN_EXTRAS = {"data_dir", "data1_dir", "data2_dir", "results_dir", "root",
                 "clips_per_genre_lang", "seed_data", "out_dir", "tol", "fast",
                 "container", "separation", "device"}


def _split_train_args(args):
    """The JAX CLI's split (``tpuvae/cli.py:56-64``): a flag named in
    ``_TRAIN_EXTRAS`` is an extra, and a bare one reads as ``"1"``; every
    other argument is a config override, passed on as written."""
    cfg_args, extras = [], {}
    for a in args:
        key, sep, value = a.lstrip("-").partition("=")
        if key in _TRAIN_EXTRAS:
            extras[key] = value if sep else "1"
        else:
            cfg_args.append(a)
    return cfg_args, extras


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    try:
        return _dispatch(argv)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"error: missing input: {e}", file=sys.stderr)
        return 2
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _dispatch(argv) -> int:
    cmd, *rest = argv
    if cmd == "synth-data":
        from tpuvae_torch.io.synthetic import generate_dataset

        dopts, positional = _parse_flags(
            cmd, rest, {"root", "clips_per_genre_lang", "container",
                        "seed_data", "separation"})
        if positional:
            raise ValueError(f"synth-data takes no positional arguments: "
                             f"{positional}")
        meta = generate_dataset(
            dopts.get("root", "Datasets"),
            clips_per_genre_lang=int(dopts.get("clips_per_genre_lang", 4)),
            container=dopts.get("container", "wav"),
            seed=int(dopts.get("seed_data", 42)),
            separation=float(dopts.get("separation", 1.0)),
        )
        print(f"synthetic dataset written; metadata: {meta}")
        return 0

    if cmd in ("preprocess", "preprocess-advanced"):
        from tpuvae_torch import pipelines
        from tpuvae_torch.config import (
            AdvancedPreprocessConfig,
            PreprocessConfig,
        )

        cfg_cls, run = (
            (PreprocessConfig, pipelines.preprocess_basic)
            if cmd == "preprocess"
            else (AdvancedPreprocessConfig, pipelines.preprocess_advanced))
        popts, positional = _parse_flags(
            cmd, rest, {"device"} | set(cfg_cls().to_dict()))
        if positional:
            raise ValueError(f"{cmd} takes no positional arguments: "
                             f"{positional}")
        cfg = cfg_cls().override(
            [f"{k}={v}" for k, v in popts.items() if k != "device"])
        run(cfg, device=popts.get("device", "cuda"))
        return 0

    if cmd == "train-simple":
        from tpuvae_torch.config import SimpleVAEConfig
        from tpuvae_torch.pipelines import run_simple_vae

        cfg_args, extras = _split_train_args(rest)
        cfg = SimpleVAEConfig().override(cfg_args)
        df = run_simple_vae(
            extras.get("data1_dir") or extras.get("data_dir", "processed_data1"),
            extras.get("results_dir", "results"), cfg, make_plots=False,
            device=extras.get("device", "cuda"))
        print(df.to_string(index=False))
        return 0

    if cmd in ("train-cvae", "train-hybrid"):
        from tpuvae_torch import config, pipelines

        cfg_cls, run = (
            (config.ConditionalVAEConfig, pipelines.run_conditional_vae)
            if cmd == "train-cvae"
            else (config.HybridVAEConfig, pipelines.run_hybrid_vae))
        cfg_args, extras = _split_train_args(rest)
        cfg = cfg_cls().override(cfg_args)
        df = run(
            extras.get("data2_dir") or extras.get("data_dir", "processed_data2"),
            extras.get("results_dir", "results"), cfg, make_plots=False,
            device=extras.get("device", "cuda"))
        print(df.to_string(index=False))
        return 0

    if cmd == "encode":
        from pathlib import Path

        import numpy as np

        from tpuvae_torch.infer import ClipEncoder

        eopts, paths = _parse_flags(
            cmd, rest, {"arch", "results_dir", "data_dir", "lyrics",
                        "lyrics_file", "genres", "out", "batch_size",
                        "device"})
        if not paths:
            raise ValueError("encode needs at least one audio file")
        enc = ClipEncoder.load(
            eopts.get("arch", "hybrid"),
            results_dir=eopts.get("results_dir", "results"),
            data_dir=eopts.get("data_dir"),
            device=eopts.get("device", "cuda"),
        )
        lyrics = None
        if "lyrics_file" in eopts:
            lyrics = Path(eopts["lyrics_file"]).read_text().splitlines()
        elif "lyrics" in eopts:
            lyrics = [eopts["lyrics"]] * len(paths)
        genres = eopts["genres"].split(",") if "genres" in eopts else None
        res = enc.encode_paths(paths, lyrics=lyrics, genres=genres,
                               batch_size=int(eopts.get("batch_size", 32)))
        for p, c in zip(res.paths, res.clusters):
            print(f"{p}\tcluster={int(c)}")
        if "out" in eopts:
            np.savez(eopts["out"], latents=res.latents,
                     clusters=res.clusters, paths=np.asarray(res.paths))
            print(f"latents saved to {eopts['out']}")
        return 0

    if cmd == "serve":
        from tpuvae_torch.serve import serve

        sopts, extra = _parse_flags(
            cmd, rest, {"arch", "results_dir", "data_dir", "host", "port",
                        "warmup", "batch_wait_ms", "max_batch", "device"})
        if extra:
            raise ValueError(f"serve takes no positional arguments: {extra}")
        serve(
            arch=sopts.get("arch", "hybrid"),
            results_dir=sopts.get("results_dir", "results"),
            data_dir=sopts.get("data_dir"),
            host=sopts.get("host", "127.0.0.1"),
            port=int(sopts.get("port", 8787)),
            warmup=sopts.get("warmup", "1") != "0",
            batch_wait_ms=float(sopts.get("batch_wait_ms", 0.0)),
            max_batch=int(sopts.get("max_batch", 32)),
            device=sopts.get("device", "cuda"),
        )
        return 0

    raise KeyError(f"unknown command {cmd!r} (the PyTorch port has "
                   f"'synth-data', 'preprocess', 'preprocess-advanced', "
                   f"'train-simple', 'train-cvae', 'train-hybrid', 'encode' "
                   f"and 'serve')")


if __name__ == "__main__":
    sys.exit(main())
