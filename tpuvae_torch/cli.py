"""Command-line interface of the PyTorch port (counterpart of the same
commands in ``tpuvae/cli.py``):

  python -m tpuvae_torch.cli synth-data  [--root=Datasets --clips_per_genre_lang=4] [--container=wav|flac|mixed]
  python -m tpuvae_torch.cli preprocess           [--key=value ...]
  python -m tpuvae_torch.cli preprocess-advanced  [--key=value ...]
  python -m tpuvae_torch.cli train-simple [--key=value ...]
  python -m tpuvae_torch.cli train-cvae   [--key=value ...]
  python -m tpuvae_torch.cli train-hybrid [--key=value ...]
  python -m tpuvae_torch.cli all          [--key=value ...]   # full end-to-end sweep
  python -m tpuvae_torch.cli encode [--arch=hybrid] song.wav [song2.wav ...]
  python -m tpuvae_torch.cli serve  [--arch=hybrid] --port=8787   # HTTP daemon
  python -m tpuvae_torch.cli eda                  # exploratory-analysis report
  python -m tpuvae_torch.cli parity               # run the sweep twice, diff metrics
  python -m tpuvae_torch.cli quality              # assert planted-structure recovery
  python -m tpuvae_torch.cli report               # print the consolidated CSV

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
extra flag: ``--device`` (default cuda).  ``stft_method``: ``ct_pallas``
= the fused FFT kernel with the fused tuning kernel (n_fft = 256 q up to
5,888, hop | n_fft); ``auto`` = ``ct_pallas`` where it takes the geometry,
else ``fft``; ``pallas`` = the dense-DFT kernel with the staged tuning
route; ``fft`` / ``dft`` / ``ct`` = library FFT / dense matmuls / the
Cooley-Tukey matmul chain with the staged route.  ``$TPUVAE_TEXT_CHECKPOINT``
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
``1``.  And the port's own ``--device`` (default cuda) and ``--plots``
(default 1): each train command draws the JAX command's figures, the
t-SNE on ``--device`` (``results/Simple_VAE/tsne_visualization_simplified.png``
here); ``--plots=0`` skips them, and with ``--plots=1`` a missing
matplotlib stops the command before any training.  ``checkpoint_every=N``
keeps rotating mid-train checkpoints under ``results/<arch>/checkpoints``;
a rerun resumes from them.

``train-cvae`` trains the Conditional VAE on a ``processed_data2`` and
writes ``results/clustering_metrics.csv`` (four rows: CVAE, PCA + K-Means,
Autoencoder + K-Means, Direct Spectral), a copy under
``results/Conditional_VAE/`` and the serving bundle
``results/Conditional_VAE/serving/``, and the figures ``reconstruction.png``,
``cvae_latent_tsne_genre.png`` and ``cluster_lang_distribution.png``.
``--key=value`` overrides map onto ``ConditionalVAEConfig``
(``--epochs=5``, ``--batch_size=8``, ``--host_stream=true`` to keep the mel
images on the host); extra flags as ``train-simple``, the data read from
``--data2_dir``, else ``--data_dir`` (default ``processed_data2``).

``train-hybrid`` trains the Hybrid VAE on a ``processed_data2`` and writes
``results/Convolutional_VAE/hybrid_latent_features.npy``,
``results/clustering_metrics.csv`` (four rows: K-Means-Main at the
silhouette-best k in 2..14, K-Means-Language at k = 2, Agglomerative (Ward)
and DBSCAN at their silhouette-best k / eps), a copy under
``results/Convolutional_VAE/`` and the serving bundle
``results/Convolutional_VAE/serving/``, and the figures
``training_loss.png`` and ``tsne_clusters_v2.png``.  Overrides map onto
``HybridVAEConfig``; extra flags and data as ``train-cvae``.

``all`` runs the reference's workflow end to end (``tpuvae/cli.py:134-219``):
``synth-data`` when there is no dataset, ``preprocess`` into
``--data1_dir`` (default ``processed_data1``) and ``preprocess-advanced``
into ``--data2_dir`` (default ``processed_data2``) when their outputs are
absent, then the three train commands into ``--results_dir``.  Each
override goes to every stage config that has the field; a field no stage
has is refused.  ``--data_dir`` never names both data directories.

``encode`` maps NEW audio clips through a trained model to latents +
nearest-training-centroid cluster ids (the serving bundle of a prior
``train-*`` run).  Flags: ``--arch`` (``hybrid``, the default, ``cvae`` or
``simple``), ``--results_dir``, ``--data_dir`` (preprocessing dir with the
scalers), ``--lyrics=<text>`` (the same lyrics for every clip) or
``--lyrics_file=<file>`` (one line per clip; ``cvae`` / ``hybrid``),
``--genres=a,b,...`` (one per clip; ``cvae``), ``--batch_size``,
``--out=<file.npz>`` to save latents/clusters, ``--device`` (default cuda),
``--mesh=1`` to shard each device batch over every rank of the process
group (``--mesh=0``, the default, encodes on this process's device; rank 0
prints and writes).
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

``eda`` writes the EDA report of ``--data_dir`` (default
``processed_data2``) to ``--out_dir`` (default ``results/EDA``): four
figures, ``feature_summary.csv``, and prints the summary.  ``parity`` runs
the three pipelines twice (3 epochs unless ``--fast=0``) under
``--out_dir`` (default ``parity_runs``) and compares the two metric CSVs
within ``--tol`` (0.01); exit code 1 on a difference.  ``quality`` runs
them once into ``--out_dir`` (default ``quality_run``) and checks the
recovery floors: ``--separation`` picks the floor set of the corpus
(``tpuvae_torch.parity.quality_floors``), ``--<floor>=value`` overrides
one floor; exit code 1 on a miss.  ``report`` prints
``<results_dir>/clustering_metrics.csv``.  Each takes ``--device``.

Global flags: ``--debug-nans`` runs the command under
``torch.autograd.set_detect_anomaly(True)``; ``--profile`` sets
``$TPUVAE_PROFILE_DIR`` (default ``profiles``), so each preprocess stage is
traced with ``torch.profiler`` into that directory.

Every command runs on the card; without CUDA it stops with an error unless
``--device=cpu`` is given.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path


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
                 "container", "separation", "device", "plots"}


def _split_train_args(args, known=_TRAIN_EXTRAS):
    """The JAX CLI's split (``tpuvae/cli.py:56-64``): a flag named in
    ``known`` is an extra, and a bare one reads as ``"1"``; every other
    argument is a config override, passed on as written."""
    cfg_args, extras = [], {}
    for a in args:
        key, sep, value = a.lstrip("-").partition("=")
        if key in known:
            extras[key] = value if sep else "1"
        else:
            cfg_args.append(a)
    return cfg_args, extras


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    debug_nans = "--debug-nans" in argv
    if debug_nans:
        argv.remove("--debug-nans")
    if "--profile" in argv:
        argv.remove("--profile")
        os.environ.setdefault("TPUVAE_PROFILE_DIR", "profiles")
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    try:
        if debug_nans:
            import torch

            with torch.autograd.set_detect_anomaly(True):
                return _dispatch(argv)
        return _dispatch(argv)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    except FileNotFoundError as e:
        print(f"error: missing input: {e}", file=sys.stderr)
        return 2
    except (ValueError, NotImplementedError, RuntimeError, ImportError) as e:
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

    if cmd in ("train-simple", "train-cvae", "train-hybrid", "all"):
        return _train(cmd, rest)

    if cmd == "encode":
        from pathlib import Path

        import numpy as np

        from tpuvae_torch.infer import ClipEncoder

        eopts, paths = _parse_flags(
            cmd, rest, {"arch", "results_dir", "data_dir", "lyrics",
                        "lyrics_file", "genres", "out", "batch_size",
                        "device", "mesh"})
        if not paths:
            raise ValueError("encode needs at least one audio file")
        mesh = None
        if eopts.get("mesh", "0") != "0":
            from tpuvae_torch.parallel import MeshContext

            # all ranks, data axis; made first, so the encoder loads onto
            # this rank's device
            mesh = MeshContext.create(device=eopts.get("device", "cuda"))
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
                               batch_size=int(eopts.get("batch_size", 32)),
                               mesh=mesh)
        if mesh is not None and not mesh.is_writer:
            return 0            # rank 0 prints and writes
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

    if cmd in ("eda", "parity", "quality", "report"):
        return _report_command(cmd, rest)

    raise KeyError(f"unknown command {cmd!r} (the PyTorch port has "
                   f"'synth-data', 'preprocess', 'preprocess-advanced', "
                   f"'train-simple', 'train-cvae', 'train-hybrid', 'all', "
                   f"'encode', 'serve', 'eda', 'parity', 'quality' and "
                   f"'report')")


def _train(cmd: str, rest) -> int:
    """``train-simple`` / ``train-cvae`` / ``train-hybrid``, and ``all``
    (``tpuvae/cli.py:96-219``)."""
    from tpuvae_torch import config, pipelines

    cfg_args, extras = _split_train_args(rest)
    device = extras.get("device", "cuda")
    plots = extras.get("plots", "1") != "0"
    # --data_dir applies to the single pipeline being trained; 'all' reads
    # --data1_dir / --data2_dir and never aliases both to one directory
    data1 = extras.get("data1_dir") or (
        extras.get("data_dir", "processed_data1") if cmd != "all"
        else "processed_data1")
    data2 = extras.get("data2_dir") or (
        extras.get("data_dir", "processed_data2") if cmd != "all"
        else "processed_data2")
    results = extras.get("results_dir", "results")

    def build_cfg(cfg_cls):
        if cmd != "all":
            return cfg_cls().override(cfg_args)
        base = cfg_cls()
        return base.override([a for a in cfg_args if
                              a.lstrip("-").split("=", 1)[0] in base.to_dict()])

    if cmd == "all":
        known = set()
        for cfg_cls in (config.SimpleVAEConfig, config.ConditionalVAEConfig,
                        config.HybridVAEConfig, config.PreprocessConfig,
                        config.AdvancedPreprocessConfig):
            known |= set(cfg_cls().to_dict())
        unknown = sorted({a.lstrip("-").split("=", 1)[0]
                          for a in cfg_args} - known)
        if unknown:
            raise KeyError(f"no stage config has field(s) {unknown}")
        _chain_preprocess(
            dataclasses.replace(build_cfg(config.PreprocessConfig),
                                output_dir=data1),
            dataclasses.replace(build_cfg(config.AdvancedPreprocessConfig),
                                output_dir=data2),
            extras, device)

    for stage, cfg_cls, run, data in (
            ("train-simple", config.SimpleVAEConfig, pipelines.run_simple_vae,
             data1),
            ("train-cvae", config.ConditionalVAEConfig,
             pipelines.run_conditional_vae, data2),
            ("train-hybrid", config.HybridVAEConfig, pipelines.run_hybrid_vae,
             data2)):
        if cmd in (stage, "all"):
            df = run(data, results, build_cfg(cfg_cls), make_plots=plots,
                     device=device)
            print(df.to_string(index=False))
    return 0


def _chain_preprocess(pre_cfg, adv_cfg, extras, device) -> None:
    """``all``'s front: synthesise a dataset when there is none, and run
    each preprocess stage whose output is absent (existing artifact
    directories are reused untouched)."""
    from tpuvae_torch import pipelines

    need_pre = not Path(pre_cfg.output_dir, "features_normalized.npy").exists()
    need_adv = not Path(adv_cfg.output_dir,
                        "mel_spectrograms_normalized.npy").exists()
    if (need_pre or need_adv) and not Path(pre_cfg.dataset_root).exists():
        from tpuvae_torch.io.synthetic import generate_dataset

        print(f"no dataset at {pre_cfg.dataset_root}; generating synthetic "
              f"clips")
        generate_dataset(pre_cfg.dataset_root,
                         seed=int(extras.get("seed_data", 42)),
                         separation=float(extras.get("separation", 1.0)))
    if need_pre:
        print(f"preprocess → {pre_cfg.output_dir}")
        pipelines.preprocess_basic(pre_cfg, device=device)
    if need_adv:
        print(f"preprocess-advanced → {adv_cfg.output_dir}")
        pipelines.preprocess_advanced(adv_cfg, device=device)


def _report_command(cmd: str, rest) -> int:
    """``eda``, ``parity``, ``quality`` and ``report``
    (``tpuvae/cli.py:301-368``)."""
    from tpuvae_torch import parity

    known = _TRAIN_EXTRAS
    if cmd == "quality":
        known = known | set(parity.QUALITY_FLOORS)
    _, extras = _split_train_args(rest, known)
    device = extras.get("device", "cuda")

    if cmd == "eda":
        from tpuvae_torch.viz.eda import run_eda

        summary = run_eda(extras.get("data_dir", "processed_data2"),
                          extras.get("out_dir", "results/EDA"), device=device)
        print(json.dumps(summary, indent=2))
        return 0

    if cmd == "report":
        import pandas as pd

        path = f"{extras.get('results_dir', 'results')}/clustering_metrics.csv"
        try:
            print(pd.read_csv(path).to_string(index=False))
        except FileNotFoundError:
            print(f"no results at {path}")
            return 1
        return 0

    common = dict(data1=extras.get("data1_dir", "processed_data1"),
                  data2=extras.get("data2_dir", "processed_data2"),
                  fast=extras.get("fast", "1") != "0", device=device)
    if cmd == "parity":
        res = parity.run_parity(work_dir=extras.get("out_dir", "parity_runs"),
                                tol=float(extras.get("tol", 0.01)), **common)
        if res["ok"]:
            print("PARITY OK: metrics reproduce within tolerance")
            return 0
        print("PARITY FAILED:")
    else:
        # --separation picks the floor set of the corpus; a --<floor>=value
        # flag overrides one floor
        floors = parity.quality_floors(float(extras.get("separation", 1.0)))
        floors.update({k: float(v) for k, v in extras.items()
                       if k in parity.QUALITY_FLOORS})
        res = parity.run_quality(
            results_dir=extras.get("out_dir", "quality_run"), floors=floors,
            **common)
        print(json.dumps(res["values"]))
        if res["ok"]:
            print("QUALITY OK: pipeline recovers the planted structure")
            return 0
        print("QUALITY FAILED:")
    for p in res["problems"]:
        print("  -", p)
    return 1


if __name__ == "__main__":
    sys.exit(main())
