"""End-to-end pipelines (counterpart of ``tpuvae/pipelines.py``).

  preprocess_basic      ≙ src/1_preprocessing.py          -> processed_data1/
  preprocess_advanced   ≙ src/1_preprocessing_advanced.py -> processed_data2/
  run_simple_vae        ≙ src/Simple_VAE.py
  run_conditional_vae   ≙ src/Conditional_VAE.py
  run_hybrid_vae        ≙ src/Convolutional_VAE.py

The preprocess pipelines decode clips on a thread pool, extract features
on the device in batches (:func:`_extract_batched`), persist each batch as
a shard so an interrupted run resumes, and write the artifact sets.
``run_simple_vae`` goes step for step as ``tpuvae/pipelines.py:587-676``
runs it — fit, ``best_vae_model/``, latents, the silhouette k-sweep, the
VAE row, the serving bundle, the PCA + KMeans row and the consolidated
metrics CSV.  ``run_conditional_vae`` goes as ``tpuvae/pipelines.py:683-815``:
one-hot genre condition, 85/15 split, fit on the validation loss, batched
latents, k-means at k = number of genres, the serving bundle, and the four
rows of ``evaluate_clustering`` (CVAE, PCA, autoencoder, raw features).
``run_hybrid_vae`` goes as ``tpuvae/pipelines.py:822-958``: the latents
file, the k-means, Ward and DBSCAN sweeps, the serving bundle and four rows
(Silhouette, Davies-Bouldin, ARI per algorithm).  With ``make_plots``
(the default, as in the JAX package) each also draws the reference's
figures, its t-SNEs on the device; with ``checkpoint_every > 0`` each
keeps rotating mid-train checkpoints under ``<arch>/checkpoints`` and
resumes from them.  Each runs on one device, or with ``mesh=`` (a
:class:`~tpuvae_torch.parallel.MeshContext`) on every rank of a mesh:
the preprocess pipelines shard each device batch over the ranks, the
training pipelines run the data-parallel epoch, and rank 0 alone writes
the files.  The artifact, shard and CSV contracts are the JAX
pipeline's, so either package reads what the other writes.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from tpuvae_torch.cluster.kmeans import centers_from_labels, kmeans
from tpuvae_torch.cluster.pca import pca_transform
from tpuvae_torch.cluster.sweeps import (
    agglomerative_k_sweep,
    dbscan_eps_sweep,
    kmeans_k_sweep,
)
from tpuvae_torch.config import (
    AdvancedPreprocessConfig,
    ClusterConfig,
    ConditionalVAEConfig,
    HybridVAEConfig,
    PreprocessConfig,
    SimpleVAEConfig,
)
from tpuvae_torch.device import resolve_device
from tpuvae_torch.dsp.features import (
    extract_advanced,
    extract_basic_features,
    make_extractor,
    resolve_transfer_dtype,
)
from tpuvae_torch.infer import save_serving_model
from tpuvae_torch.io.artifacts import (
    load_advanced,
    load_basic,
    save_advanced,
    save_basic,
    save_latents,
)
from tpuvae_torch.io import native_loader
from tpuvae_torch.io.catalog import collect_audio_files
from tpuvae_torch.io.normalize import impute_and_scale, normalize_mel_images
from tpuvae_torch.io.results import consolidate_metrics
from tpuvae_torch.io.resume import ExtractionManifest
from tpuvae_torch.io.wav import load_audio
from tpuvae_torch.metrics.internal import (
    calinski_harabasz_score,
    davies_bouldin_score,
    silhouette_from_distances,
)
from tpuvae_torch.metrics.external import (
    adjusted_rand_score,
    normalized_mutual_info,
    purity_score,
)
from tpuvae_torch.metrics.labels import (
    compact_labels,
    encode_labels,
    one_hot_np,
)
from tpuvae_torch.metrics.pairwise import self_distances
from tpuvae_torch.models import (
    ConditionalVAE,
    HybridVAE,
    SimpleAutoencoder,
    SimpleVAE,
)
from tpuvae_torch.models.layers import compute_dtype
from tpuvae_torch.parallel.mesh import MeshContext
from tpuvae_torch.train.checkpoint import save_checkpoint
from tpuvae_torch.train.loop import FitConfig, fit, train_val_split
from tpuvae_torch.train.objectives import (
    autoencoder_objective,
    cvae_objective,
    hybrid_objective,
    simple_vae_objective,
)
from tpuvae_torch.train.state import create_state
from tpuvae_torch.utils.batching import RowView, batched_apply
from tpuvae_torch.text.embedder import embed_lyrics
from tpuvae_torch.utils.logging import RunLogger, StageTimer
from tpuvae_torch.viz.plots import (
    cluster_language_bar,
    loss_curve,
    pyplot,
    reconstruction_pair,
    tsne_by_genre,
    tsne_cluster_language,
    tsne_triptych,
)
from tpuvae_torch.viz.tsne import tsne


# -----------------------------------------------------------------------------
# Shared extraction loop
# -----------------------------------------------------------------------------

def _loader_workers() -> int:
    """Decode-pool width: ``TPUVAE_LOADER_THREADS`` override, else one
    thread per core up to 32 (WAV decode is numpy code that releases the
    GIL over the large arrays)."""
    env = os.environ.get("TPUVAE_LOADER_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(32, (os.cpu_count() or 1)))


class _BatchSlot:
    """One of the rotating batch buffers: a host buffer the loader threads
    fill (pinned when the device is a card), its device twin, and the two
    events that say when each may be written again."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        on_card = device.type == "cuda"
        # every row is written whole by its loader before it is read
        self.host = torch.empty(shape, dtype=dtype, pin_memory=on_card)
        self.host_np = self.host.numpy()
        self.dev = (torch.empty(shape, dtype=dtype, device=device)
                    if on_card else self.host)
        self.copied = None      # recorded after the copy that read `host`
        self.consumed = None    # recorded after the extraction that read `dev`


def _extract_batched(entries, extract_fn, cfg, device: torch.device,
                     logger: RunLogger | None = None,
                     manifest=None, shard_keys: tuple = ("out",),
                     mesh: MeshContext | None = None):
    """Decode clips into preallocated batch buffers on a thread pool,
    extract on the device, skip-and-tally failures (ref per-file
    try/except, ``1_preprocessing.py:237-256``).

    On a card the stages of consecutive batches overlap, each ordered by
    CUDA events and never by a device-wide synchronize:

    * loader threads write each clip into its slot of one of three
      rotating **pinned** ``(extract_batch, num_samples)`` buffers in the
      wire dtype (int16 PCM in fast mode), through the native rows loader
      (decode, mono, resample and placement in one C++ pass; the Python
      decoders only for a container it cannot read);
    * the main thread enqueues a non-blocking copy on a copy stream into
      the slot's device twin, then the extraction on the compute stream,
      which waits for the copy's event.  A host buffer is decoded into
      again only after the copy that read it has finished, a device buffer
      copied into again only after the extraction that read it;
    * one drain-worker thread waits for the batch's extraction event,
      copies the outputs to pinned host memory on a fetch stream, and
      persists the shard.

    On the CPU the same loop runs without streams.  With a ``manifest``
    (:class:`tpuvae_torch.io.resume.ExtractionManifest`) each flushed batch
    is persisted as a shard so interrupted runs resume.  A clip that fails
    to decode is skipped and returned in ``failed``; nothing that happens
    on the device is caught.

    With a ``mesh`` of D > 1 ranks on its data axis
    (``tpuvae/pipelines.py:133-260``) every rank decodes the whole batch,
    as the JAX host does, so the skip-and-tally and the compaction over
    failed slots give the same result on every rank.  The batch buffer
    holds ``extract_batch`` rounded up to a multiple of D rows, the rows
    past the kept clips zeroed; each rank copies and extracts its own
    contiguous block of them, one all-gather per output puts the batch
    back in order (its time is part of ``device``), and only rank 0
    writes the shard.
    """
    t_setup = time.time()
    # int() truncation, matching load_audio's clip-length convention
    nsamp = int(cfg.sample_rate * cfg.duration)
    bs = cfg.extract_batch
    n_dev = mesh.data_size if mesh is not None else 1
    # the sharded batch must divide over the mesh's data axis
    bs_padded = -(-bs // n_dev) * n_dev
    per_rank = bs_padded // n_dev
    mine = (slice(mesh.rank * per_rank, (mesh.rank + 1) * per_rank)
            if n_dev > 1 else None)
    writes = mesh is None or mesh.is_writer
    on_card = device.type == "cuda"
    wire = resolve_transfer_dtype(cfg)
    wire_t = torch.int16 if wire == np.int16 else torch.float32
    slots = [_BatchSlot((bs_padded, nsamp), wire_t, device)
             for _ in range(3)]
    if on_card:
        compute = torch.cuda.current_stream(device)
        copy_stream = torch.cuda.Stream(device)
        fetch_stream = torch.cuda.Stream(device)
    ok_entries, outputs, failed = [], [], []

    def load_slot(e, dest):
        load_audio(e.path, cfg.sample_rate, cfg.duration, out=dest)

    # main-thread wall = setup + decode_wait + drain_wait + enqueue overhead:
    #   setup        — allocating (and pinning) the batch buffers
    #   decode_wait  — blocking on loader futures (0 when decode fully
    #                  overlaps the device work of earlier batches)
    #   transfer     — the host->device copies (CUDA events on the card)
    #   device       — the extractions (CUDA events on the card: a host
    #                  clock around an asynchronous launch reads near zero)
    #   drain_wait   — backpressure: blocking on the drain worker when two
    #                  outputs are still in flight
    #   fetch_worker / persist_worker — the drain worker's wait for the
    #                  extraction plus the device->host fetch, and the
    #                  shard write; they overlap the next batches
    #   decodes_native / decodes_python — clips each decoder read
    detail = {"decode_wait_s": 0.0, "transfer_s": 0.0, "device_s": 0.0,
              "drain_wait_s": 0.0, "fetch_worker_s": 0.0,
              "persist_worker_s": 0.0, "wire_mb_per_batch":
              round(slots[0].host_np.nbytes / 2**20, 1),
              "setup_s": time.time() - t_setup}

    fetch_host: list = []   # the drain worker's pinned output buffers

    def drain_one(kept, out_dev, timing):
        t0 = time.time()
        n = len(kept)
        if on_card:
            t_copy0, t_copy1, t_dev0, t_dev1 = timing
            if not fetch_host:
                # pinned once, at the first batch: this worker is the only
                # reader, and it has written or copied a batch's rows out
                # (below) before it fetches the next batch into them
                fetch_host.extend(
                    torch.empty((bs_padded,) + tuple(o.shape[1:]),
                                dtype=o.dtype, pin_memory=True)
                    for o in out_dev)
            with torch.cuda.stream(fetch_stream):
                fetch_stream.wait_event(t_dev1)
                for h, o in zip(fetch_host, out_dev):
                    h[:n].copy_(o[:n], non_blocking=True)
            fetch_stream.synchronize()
            detail["transfer_s"] += t_copy0.elapsed_time(t_copy1) / 1e3
            detail["device_s"] += t_dev0.elapsed_time(t_dev1) / 1e3
            out_np = tuple(h[:n].numpy() for h in fetch_host)
        else:
            out_np = tuple(o[:n].numpy() for o in out_dev)
        t1 = time.time()
        detail["fetch_worker_s"] += t1 - t0
        if manifest is not None:
            # shards on disk are the source of truth; no second in-RAM copy
            if writes:
                manifest.add_shard([e.file_id for e in kept],
                                   dict(zip(shard_keys, out_np)))
            detail["persist_worker_s"] += time.time() - t1
        else:
            outputs.append(tuple(np.array(o) for o in out_np))
        ok_entries.extend(kept)

    drain: deque = deque()      # in-flight (future) outputs, depth <= 2

    def gather(out):
        """The whole batch's outputs from every rank's block (a collective:
        the main thread calls it, in batch order on every rank)."""
        if mine is None:
            return out
        if isinstance(out, tuple):
            return tuple(mesh.gather_rows(o) for o in out)
        return mesh.gather_rows(out)

    def process(chunk, slot, futures, writer):
        t0 = time.time()
        kept = []
        for j, (e, fut) in enumerate(zip(chunk, futures)):
            try:
                fut.result()
            except Exception as exc:  # skip-and-tally contract (decode only)
                failed.append((e.path, str(exc)))
                if logger:
                    logger.log("decode_failed", path=e.path,
                               error=f"{type(exc).__name__}: {exc}")
                continue
            k = len(kept)
            if k != j:          # compact over failed slots (rare)
                slot.host_np[k] = slot.host_np[j]
            kept.append(e)
        detail["decode_wait_s"] += time.time() - t0
        if not kept:
            return
        n = len(kept)
        rows = slice(0, n)
        if mine is not None:
            slot.host_np[n:] = 0        # the pad rows of the sharded batch
            rows = mine
        if on_card:
            t_copy0 = torch.cuda.Event(enable_timing=True)
            t_copy1 = torch.cuda.Event(enable_timing=True)
            t_dev0 = torch.cuda.Event(enable_timing=True)
            t_dev1 = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(copy_stream):
                if slot.consumed is not None:
                    copy_stream.wait_event(slot.consumed)
                t_copy0.record(copy_stream)
                slot.dev[rows].copy_(slot.host[rows], non_blocking=True)
                t_copy1.record(copy_stream)
            slot.copied = t_copy1
            compute.wait_event(t_copy1)
            t_dev0.record(compute)
            out = gather(extract_fn(slot.dev[rows]))
            t_dev1.record(compute)
            slot.consumed = t_dev1
            timing = (t_copy0, t_copy1, t_dev0, t_dev1)
        else:
            t1 = time.time()
            out = gather(extract_fn(slot.dev[rows]))
            detail["device_s"] += time.time() - t1
            timing = None
        out_list = out if isinstance(out, tuple) else (out,)
        # bound the in-flight device outputs (the mel images)
        while len(drain) >= 2:
            t3 = time.time()
            drain.popleft().result()
            detail["drain_wait_s"] += time.time() - t3
        drain.append(writer.submit(drain_one, kept, out_list, timing))

    decodes0 = native_loader.decode_counts()
    it = iter(entries)
    pending: deque = deque()
    ci = 0
    with ThreadPoolExecutor(max_workers=_loader_workers()) as pool, \
            ThreadPoolExecutor(max_workers=1) as writer:
        while True:
            while len(pending) < 2:
                chunk = list(islice(it, bs))
                if not chunk:
                    break
                slot = slots[ci % len(slots)]
                ci += 1
                if slot.copied is not None:
                    slot.copied.synchronize()   # the copy three batches back
                pending.append((chunk, slot, [
                    pool.submit(load_slot, e, slot.host_np[j])
                    for j, e in enumerate(chunk)
                ]))
            if not pending:
                break
            process(*pending.popleft(), writer)
        while drain:            # propagate drain-worker exceptions
            t3 = time.time()
            drain.popleft().result()
            detail["drain_wait_s"] += time.time() - t3
    for k, v in native_loader.decode_counts().items():
        detail[f"decodes_{k}"] = v - decodes0[k]
    detail = {k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in detail.items()}
    if logger:
        logger.log("extract", ok=len(ok_entries), failed=len(failed),
                   loader_threads=_loader_workers(), **detail)
    return ok_entries, outputs, failed, detail


def _metadata_frame(entries, labels):
    df = pd.DataFrame(
        [
            {"language": e.language, "genre": e.genre, "filename": e.filename,
             "file_id": e.file_id}
            for e in entries
        ]
    )
    df["label"] = labels
    return df


def _resume_manifest(output_dir, entries, resume: bool, logger: RunLogger,
                     mesh: MeshContext):
    """``(manifest or None, entries still to extract)``; every rank reads
    the manifest before rank 0 writes to it."""
    if not resume:
        return None, entries
    manifest = ExtractionManifest(output_dir)
    pending = manifest.filter_pending(entries)
    if len(pending) < len(entries):
        logger.log("resume", already_done=len(entries) - len(pending))
    mesh.barrier()
    return manifest, pending


def _shards_written(manifest, output_dir, mesh: MeshContext):
    """Wait until rank 0 has written every shard; the other ranks then
    read its manifest anew."""
    mesh.barrier()
    if manifest is None or mesh.is_writer:
        return manifest
    return ExtractionManifest(output_dir)


def _entries_of(ids, entries, manifest):
    """The catalog entries of the manifest's file ids, in manifest order."""
    by_id = {e.file_id: e for e in entries}
    unknown = [i for i in ids if i not in by_id]
    if unknown:
        raise ValueError(
            f"extraction manifest contains {len(unknown)} file ids not in "
            f"the current catalog (config/catalog changed between runs?); "
            f"delete {manifest.dir} to start fresh")
    return [by_id[i] for i in ids]


def _pipeline_device(device, mesh: MeshContext | None) -> torch.device:
    """The device a pipeline computes on: ``device`` (CUDA by default,
    raising without a card), or with a mesh its rank's device, which must
    be of the same type."""
    dev = resolve_device(device)
    if mesh is None:
        return dev
    if mesh.device.type != dev.type:
        raise ValueError(f"device {device!r} and the mesh's "
                         f"{mesh.device.type!r} differ")
    return mesh.device


# -----------------------------------------------------------------------------
# Preprocessing pipelines
# -----------------------------------------------------------------------------

def preprocess_basic(
    cfg: PreprocessConfig = PreprocessConfig(),
    device: str = "cuda",
    logger: RunLogger | None = None,
    resume: bool = True,
    mesh: MeshContext | None = None,
) -> dict:
    """Raw audio under ``cfg.dataset_root`` -> ``processed_data1/`` (370-d
    features, normalizers, labels, metadata).  ``device`` defaults to CUDA
    and raises without a card.

    ``mesh`` (default: :meth:`MeshContext.create` over every rank of the
    process group, a world of one in a plain process) shards each device
    batch over its data axis (:func:`_extract_batched`).  Every rank runs
    the pipeline on the same inputs and returns the same counts; rank 0
    writes the shards and the artifacts, the others wait at a barrier."""
    mesh = mesh or MeshContext.create(device=device)
    dev = _pipeline_device(device, mesh)
    logger = logger or RunLogger()
    timer = StageTimer(logger,
                       profile_dir=os.environ.get("TPUVAE_PROFILE_DIR"))
    with timer.stage("catalog"):
        entries, skipped = collect_audio_files(
            cfg.dataset_root, cfg.metadata_csv,
            max_per_class=cfg.max_samples_per_class, strict=False,
        )
    manifest, pending = _resume_manifest(cfg.output_dir, entries, resume,
                                         logger, mesh)
    extract = make_extractor(extract_basic_features, cfg, dev)
    with timer.stage("extract_basic", items=len(pending)):
        ok, outs, failed, detail = _extract_batched(
            pending, extract, cfg, dev, logger,
            manifest=manifest, shard_keys=("features",), mesh=mesh,
        )
    manifest = _shards_written(manifest, cfg.output_dir, mesh)
    t_asm = time.time()
    if manifest is not None:
        ids, arrays = manifest.load_all()
        ok = _entries_of(ids, entries, manifest)
        features = arrays.get("features", np.zeros((0, cfg.feature_dim)))
        assert len(ok) == len(features), (len(ok), len(features))
    else:
        features = (np.concatenate([o[0] for o in outs])
                    if outs else np.zeros((0, cfg.feature_dim)))
    timer.stages["assemble"] = {"seconds": time.time() - t_asm}
    if not ok:
        raise ValueError("No audio files collected! Check paths and metadata.")
    labels = np.array([e.genre for e in ok])
    with timer.stage("normalize"):
        normalized, imputer, scaler = impute_and_scale(features)
    with timer.stage("save_artifacts"):
        if mesh.is_writer:
            save_basic(
                cfg.output_dir,
                features_raw=features, features_normalized=normalized,
                labels=labels,
                metadata=_metadata_frame(ok, labels)[
                    ["language", "genre", "filename", "label"]],
                scaler=scaler, imputer=imputer, config=cfg,
            )
        mesh.barrier()      # every rank has read the shards
    if manifest is not None and mesh.is_writer:
        manifest.cleanup()
    logger.log("saved", dir=cfg.output_dir, n=len(ok),
               feature_dim=int(features.shape[1]), failed=len(failed),
               skipped=skipped)
    return {"n": len(ok), "failed": failed, "stages": timer.stages,
            "extract_detail": detail}


def preprocess_advanced(
    cfg: AdvancedPreprocessConfig = AdvancedPreprocessConfig(),
    device: str = "cuda",
    logger: RunLogger | None = None,
    text_checkpoint: str | None = None,
    resume: bool = True,
    mesh: MeshContext | None = None,
) -> dict:
    """Raw audio + lyrics -> ``processed_data2/`` (mel images, 290-d
    features, 768-d lyrics embeddings, normalizers, labels, metadata).
    ``device`` defaults to CUDA and raises without a card.  The lyrics are
    embedded by the XLM-R encoder of ``text_checkpoint`` (else
    ``$TPUVAE_TEXT_CHECKPOINT``) on ``device``, else by hashed n-grams;
    ``config.pkl`` records which (``lyrics_embedder_backend``).  ``mesh``
    as :func:`preprocess_basic`'s; with the streaming assembly only rank 0
    streams the mel artifacts to disk, the others read the shards' ids and
    flat features."""
    if cfg.assembly_mode not in ("auto", "inmem", "stream"):
        raise ValueError(f"assembly_mode must be 'auto'|'inmem'|'stream', "
                         f"got {cfg.assembly_mode!r}")
    if cfg.assembly_mode == "stream" and not resume:
        raise ValueError("assembly_mode='stream' requires resume=True "
                         "(extraction shards are the streaming source)")
    mesh = mesh or MeshContext.create(device=device)
    dev = _pipeline_device(device, mesh)
    logger = logger or RunLogger()
    timer = StageTimer(logger,
                       profile_dir=os.environ.get("TPUVAE_PROFILE_DIR"))
    with timer.stage("catalog"):
        entries, skipped = collect_audio_files(
            cfg.dataset_root, cfg.metadata_csv,
            max_per_class=cfg.max_samples_per_class, strict=True,
            exclude_genres=cfg.exclude_genres,
            min_lyrics_chars=cfg.min_lyrics_chars,
        )
    if not entries:
        raise ValueError("No audio files collected! Check paths and metadata.")
    manifest, pending = _resume_manifest(cfg.output_dir, entries, resume,
                                         logger, mesh)
    extract = make_extractor(extract_advanced, cfg, dev)
    with timer.stage("extract_advanced", items=len(pending)):
        ok, outs, failed, detail = _extract_batched(
            pending, extract, cfg, dev, logger,
            manifest=manifest, shard_keys=("mel", "flat"), mesh=mesh,
        )
    manifest = _shards_written(manifest, cfg.output_dir, mesh)
    streaming = False
    t_asm = time.time()
    if manifest is not None:
        mel_bytes = manifest.total_rows() * cfg.n_mels * cfg.fixed_time_steps * 4
        streaming = bool(manifest.total_rows()) and (
            cfg.assembly_mode == "stream"
            or (cfg.assembly_mode == "auto" and mel_bytes > 1 << 30))
        if streaming and not mesh.is_writer:
            ids, arrays = manifest.load_all(keys=("flat",))
            flats, mel_scaler, mels = arrays["flat"], None, None
        elif streaming:
            from tpuvae_torch.io.assembly import assemble_advanced_streaming

            with timer.stage("assemble_stream", items=manifest.total_rows()):
                ids, flats, mel_scaler = assemble_advanced_streaming(
                    manifest, cfg.output_dir,
                    (cfg.n_mels, cfg.fixed_time_steps), cfg.flat_feature_dim,
                )
            mels = None  # on disk already; never resident
        else:
            ids, arrays = manifest.load_all()
            mels = arrays.get("mel",
                              np.zeros((0, cfg.n_mels, cfg.fixed_time_steps)))
            flats = arrays.get("flat", np.zeros((0, cfg.flat_feature_dim)))
        ok = _entries_of(ids, entries, manifest)
        assert len(ok) == len(flats), (len(ok), len(flats))
    else:
        mels = (np.concatenate([o[0] for o in outs]) if outs
                else np.zeros((0, cfg.n_mels, cfg.fixed_time_steps)))
        flats = (np.concatenate([o[1] for o in outs]) if outs
                 else np.zeros((0, cfg.flat_feature_dim)))
    if not ok:
        raise ValueError(
            "No audio files decoded successfully! Check paths and formats.")
    # shard reload / in-RAM concatenate, net of assemble_stream, which
    # times itself when streaming
    asm = time.time() - t_asm - timer.stages.get(
        "assemble_stream", {}).get("seconds", 0.0)
    timer.stages["assemble"] = {"seconds": asm}
    labels = np.array([e.genre for e in ok])
    with timer.stage("lyrics_embeddings", items=len(ok)):
        embeddings, embedder_backend = embed_lyrics(
            [e.lyrics for e in ok], checkpoint=text_checkpoint, device=dev)
    logger.log("lyrics_embedder", backend=embedder_backend)
    assert len(ok) == len(embeddings), "Mismatch between audio and lyrics samples!"
    with timer.stage("normalize"):
        if not streaming:
            mel_norm, mel_scaler = normalize_mel_images(mels)
        else:  # mel artifacts + scaler already written by the streaming pass
            mel_norm = None
        flat_norm, imputer, flat_scaler = impute_and_scale(flats)
    with timer.stage("save_artifacts"):
        if mesh.is_writer:
            save_advanced(
                cfg.output_dir,
                mel_raw=mels, mel_normalized=mel_norm,
                features_raw=flats, features_normalized=flat_norm,
                lyrics_embeddings=embeddings, labels=labels,
                metadata=_metadata_frame(ok, labels),
                mel_scaler=mel_scaler, flat_scaler=flat_scaler,
                imputer=imputer,
                # record WHICH embedder produced lyrics_embeddings.npy so
                # downstream results are attributable
                config={**cfg.to_dict(),
                        "lyrics_embedder_backend": embedder_backend},
            )
        mesh.barrier()      # every rank has read the shards
    if manifest is not None and mesh.is_writer:
        manifest.cleanup()
    logger.log("saved", dir=cfg.output_dir, n=len(ok), failed=len(failed),
               skipped=skipped)
    return {"n": len(ok), "failed": failed, "stages": timer.stages,
            "extract_detail": detail}


# -----------------------------------------------------------------------------
# Training pipelines
# -----------------------------------------------------------------------------


def _ckpt_kwargs(cfg, default_dir: str) -> dict:
    """FitConfig checkpoint kwargs from a model config
    (``tpuvae/pipelines.py:570-582``): rotating mid-train checkpoints under
    ``default_dir`` when ``checkpoint_every > 0`` (off by default; the
    reference persists nothing mid-train)."""
    if cfg.checkpoint_every <= 0:
        return {}
    return {"checkpoint_dir": default_dir,
            "checkpoint_every": cfg.checkpoint_every,
            "checkpoint_keep": cfg.checkpoint_keep}


def _fit_mesh(mesh: MeshContext | None, batch_size: int, logger=None):
    """The ``DeviceMesh`` to hand to ``fit`` (``tpuvae/pipelines.py:534-544``):
    the data-parallel epoch when the mesh has several ranks and the batch
    divides across them, else None (each rank then trains the same model
    on the whole data, as one device would)."""
    if mesh is None or mesh.data_size <= 1:
        return None
    if batch_size % mesh.data_size:
        if logger is not None:
            logger.log("dp_disabled", reason="batch_size % n_devices != 0",
                       batch_size=batch_size, n_devices=mesh.data_size)
        return None
    return mesh.mesh


def _writes(mesh: MeshContext | None) -> bool:
    """This rank writes the files: rank 0, or the only process."""
    return mesh is None or mesh.is_writer


def _done_writing(mesh: MeshContext | None) -> None:
    """The other ranks wait until rank 0 has written."""
    if mesh is not None:
        mesh.barrier()


def _silhouette_ch(x: torch.Tensor, labels: np.ndarray) -> tuple[float, float]:
    lab, k = compact_labels(labels)
    sil = float(silhouette_from_distances(self_distances(x), lab, k))
    return sil, float(calinski_harabasz_score(x, lab, k))


def run_simple_vae(
    data_dir: str = "processed_data1",
    results_dir: str = "results",
    cfg: SimpleVAEConfig = SimpleVAEConfig(),
    ccfg: ClusterConfig = ClusterConfig(),
    logger: RunLogger | None = None,
    make_plots: bool = True,
    device: str = "cuda",
    mesh: MeshContext | None = None,
) -> pd.DataFrame:
    """Train the Simple VAE on ``data_dir`` (a ``processed_data1``) and
    write its metrics, best weights and serving bundle under
    ``results_dir``; with ``make_plots`` also the t-SNE figure by cluster
    and language (``Simple_VAE/tsne_visualization_simplified.png``).
    Returns the two metric rows.

    ``device`` defaults to CUDA and raises without a card.  With
    ``make_plots`` a missing matplotlib raises before any training.  With
    a ``mesh`` of several ranks (every rank calls this with the same
    arguments) ``fit`` runs the data-parallel epoch on the ``'mean'``
    objective; the clustering runs on every rank, gives every rank the
    same rows, and rank 0 alone writes the files and draws the figure.
    """
    dev = _pipeline_device(device, mesh)
    if make_plots:
        pyplot()
    logger = logger or RunLogger()
    data = load_basic(data_dir)
    features = np.asarray(data["features"], np.float32)
    input_dim = features.shape[1]

    model = SimpleVAE(input_dim=input_dim, hidden_dims=tuple(cfg.hidden_dims),
                      latent_dim=cfg.latent_dim, dropout=cfg.dropout,
                      generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    state = create_state(model, cfg.learning_rate)
    fit_cfg = FitConfig(
        epochs=cfg.epochs, batch_size=cfg.batch_size, patience=cfg.patience,
        monitor="train", restore_best=True,
        plateau_patience=cfg.plateau_patience, plateau_factor=cfg.plateau_factor,
        seed=cfg.seed, scan_epochs=cfg.scan_epochs,
        **_ckpt_kwargs(cfg, f"{results_dir}/Simple_VAE/checkpoints"),
    )
    xd = torch.from_numpy(features).to(dev)
    t0 = time.perf_counter()
    res = fit(state, simple_vae_objective(cfg.beta), (xd,), fit_cfg,
              logger=logger, mesh=_fit_mesh(mesh, cfg.batch_size, logger),
              loss_reduction="mean")
    epochs_run = len(res.history["train_loss"])
    logger.log("fit", seconds=time.perf_counter() - t0, epochs=epochs_run,
               best_epoch=res.best_epoch, stopped_epoch=res.stopped_epoch,
               steps_per_sec=res.steps_per_sec, host_reads=res.host_reads,
               epoch_seconds=res.history["epoch_seconds"],
               train_loss=res.history["train_loss"], lr=res.history["lr"])
    if _writes(mesh):
        save_checkpoint(f"{results_dir}/Simple_VAE/best_vae_model", model,
                        {"best_epoch": res.best_epoch})

    model.eval()
    with torch.no_grad():
        latents = batched_apply(
            lambda x: model.latent(torch.from_numpy(x).to(dev)),
            (features,), cfg.batch_size)
    logger.log("latents", shape=list(latents.shape))

    # K-sweep by silhouette (ref :239-252)
    t0 = time.perf_counter()
    xl = torch.from_numpy(latents).to(dev)
    sweep = kmeans_k_sweep(xl, ccfg.simple_k_sweep,
                           n_init=ccfg.kmeans_n_init, seed=ccfg.seed)
    best_k = int(sweep.best_param)
    vae_clusters = sweep.best_labels
    logger.log("k_sweep", seconds=time.perf_counter() - t0, best_k=best_k,
               scores=sweep.scores)
    vae_sil, vae_ch = _silhouette_ch(xl, vae_clusters)

    centers = centers_from_labels(latents, vae_clusters)
    if _writes(mesh):
        serving = save_serving_model(
            results_dir, model, centers,
            meta={"arch": "simple", "best_epoch": res.best_epoch,
                  "best_k": best_k, "input_dim": int(input_dim),
                  "hidden_dims": list(cfg.hidden_dims),
                  "latent_dim": cfg.latent_dim, "dropout": cfg.dropout,
                  "data_dir": str(data_dir)})
        logger.log("serving_saved", dir=str(serving), n_centers=len(centers))

    # PCA(latent_dim)+KMeans baseline (ref :258-263)
    t0 = time.perf_counter()
    pca_feats = pca_transform(xd, cfg.latent_dim)
    pca_res = kmeans(pca_feats, best_k, n_init=ccfg.kmeans_n_init, seed=ccfg.seed)
    pca_sil, pca_ch = _silhouette_ch(pca_feats, pca_res.labels)
    logger.log("pca_row", seconds=time.perf_counter() - t0)

    df = pd.DataFrame({
        "Method": ["VAE + KMeans", "PCA + KMeans"],
        "Silhouette": [vae_sil, pca_sil],
        "Calinski-Harabasz": [vae_ch, pca_ch],
    })
    if _writes(mesh):
        consolidate_metrics(results_dir, df, "Simple VAE")
    logger.log("metrics", architecture="Simple VAE",
               rows=df.to_dict("records"))

    if make_plots and _writes(mesh):
        xy = tsne(latents, perplexity=ccfg.tsne_perplexity, seed=ccfg.seed,
                  device=dev)
        tsne_cluster_language(
            xy, vae_clusters, data["metadata"]["language"].values, best_k,
            f"{results_dir}/Simple_VAE/tsne_visualization_simplified.png")
    _done_writing(mesh)
    return df


# -----------------------------------------------------------------------------
# Shared evaluation helper (ref evaluate_clustering, Conditional_VAE.py:289-308)
# -----------------------------------------------------------------------------

def evaluate_clustering(latents, y_true_codes, n_true: int,
                        seed: int = 42) -> dict:
    """KMeans with k = #true classes; Silhouette + NMI + ARI + Purity.
    ``latents`` is a tensor (the work runs where it lies) or a host array."""
    x = torch.as_tensor(latents, dtype=torch.float32)
    km = kmeans(x, n_true, n_init=10, seed=seed)
    lab, k = compact_labels(km.labels)
    sil = float(silhouette_from_distances(self_distances(x), lab, k))
    return {
        "Silhouette": sil,
        "NMI": normalized_mutual_info(y_true_codes, lab, n_true, k),
        "ARI": adjusted_rand_score(y_true_codes, lab, n_true, k),
        "Purity": purity_score(y_true_codes, lab, n_true, k),
    }


def _batched_latents(fn, arrays, batch_size: int,
                     device: torch.device) -> np.ndarray:
    """``fn`` over host ``arrays`` in batches on ``device`` (the reference
    encodes all N mel images in one tensor, ``Conditional_VAE.py:398-402``);
    returns the host result in float32.  A bfloat16 model's latents are
    widened exactly: their values stay bfloat16 values, which the
    clustering reads in float32 as the JAX package's does
    (``tpuvae/cluster/kmeans.py:139``)."""
    with torch.no_grad():
        return batched_apply(
            lambda *chunk: fn(*(torch.from_numpy(np.array(c))
                                .to(device) for c in chunk)).float(),
            arrays, batch_size)


def _mel_nhwc(data, stream: bool):
    """The mel images as NHWC: a lazy view of the memory map when
    streaming (the big tensor stays on disk), else one float32 array."""
    if stream:
        return RowView(data["mel"], add_channel=True)
    return np.asarray(data["mel"], np.float32)[..., None]


def _fit_splits(data, mel, others, rows, stream: bool, dev):
    """``(mel, *others)`` of each row set in ``rows``: host views that
    ``fit(host_stream=True)`` moves one batch at a time, else device
    tensors."""
    if stream:
        return [(RowView(data["mel"], r, add_channel=True),
                 *(a[r] for a in others)) for r in rows]
    return [tuple(torch.from_numpy(a[r]).to(dev) for a in (mel, *others))
            for r in rows]


# -----------------------------------------------------------------------------
# Conditional VAE pipeline (≙ src/Conditional_VAE.py main())
# -----------------------------------------------------------------------------

def run_conditional_vae(
    data_dir: str = "processed_data2",
    results_dir: str = "results",
    cfg: ConditionalVAEConfig = ConditionalVAEConfig(),
    ccfg: ClusterConfig = ClusterConfig(),
    logger: RunLogger | None = None,
    make_plots: bool = True,
    device: str = "cuda",
    mesh: MeshContext | None = None,
) -> pd.DataFrame:
    """Train the Conditional VAE on ``data_dir`` (a ``processed_data2``),
    cluster its latents at k = number of genres, and write the serving
    bundle and the four metric rows under ``results_dir``; with
    ``make_plots`` also the reconstruction pair, the t-SNE by genre and
    the cluster x language bars under ``Conditional_VAE/``.  Returns the
    rows.

    ``device`` defaults to CUDA and raises without a card.  On the card
    every float32 trunk forward launches kernel 6, every
    ``evaluate_clustering`` kernel 5, and the t-SNE kernel 5 1,001 times.
    ``cfg.compute_dtype="bfloat16"`` trains and encodes in bfloat16 as the
    JAX pipeline does (``layers.ConvEncoderTrunk``: no kernel 6 there);
    the weights and the optimizer stay float32.  With ``make_plots`` a
    missing matplotlib raises before any training.  ``mesh`` as
    :func:`run_simple_vae`'s, on the ``'sum'`` objective (the autoencoder
    baseline trains on every rank, unsharded, as in the JAX pipeline).
    """
    dtype = compute_dtype(cfg.compute_dtype)
    dev = _pipeline_device(device, mesh)
    if make_plots:
        pyplot()
    logger = logger or RunLogger()
    t_start = time.perf_counter()
    stream = bool(cfg.host_stream)
    data = load_advanced(data_dir, mmap=stream)
    mel = _mel_nhwc(data, stream)
    text = np.asarray(data["text"], np.float32)
    handcrafted = np.asarray(data["handcrafted"], np.float32)
    y_genre, genre_names = encode_labels(data["metadata"]["genre"].values)
    cond = one_hot_np(y_genre)
    n_classes = cond.shape[1]

    model = ConditionalVAE(
        latent_dim=cfg.latent_dim, text_dim=text.shape[1],
        num_classes=n_classes, input_hw=(mel.shape[1], mel.shape[2]),
        generator=torch.Generator().manual_seed(cfg.seed), dtype=dtype).to(dev)
    state = create_state(model, cfg.learning_rate)
    tr, va = train_val_split(len(mel), cfg.val_fraction, cfg.seed)
    fit_cfg = FitConfig(
        epochs=cfg.epochs, batch_size=cfg.batch_size, patience=cfg.patience,
        monitor="val", restore_best=False, seed=cfg.seed,
        scan_epochs=cfg.scan_epochs, host_stream=stream,
        **_ckpt_kwargs(cfg, f"{results_dir}/Conditional_VAE/checkpoints"),
    )
    splits = _fit_splits(data, mel, (text, cond), (tr, va), stream, dev)
    t0 = time.perf_counter()
    logger.log("fit_start", setup_seconds=t0 - t_start, n_train=len(tr),
               n_val=len(va), host_stream=stream)
    res = fit(state, cvae_objective(cfg.beta, cfg.text_loss_weight),
              splits[0], fit_cfg, val_data=splits[1], logger=logger,
              mesh=_fit_mesh(mesh, cfg.batch_size, logger),
              loss_reduction="sum")
    del splits
    logger.log("fit", seconds=time.perf_counter() - t0,
               epochs=len(res.history["train_loss"]),
               best_epoch=res.best_epoch, stopped_epoch=res.stopped_epoch,
               steps_per_sec=res.steps_per_sec, host_reads=res.host_reads,
               epoch_seconds=res.history["epoch_seconds"],
               train_loss=res.history["train_loss"],
               val_loss=res.history["val_loss"], lr=res.history["lr"])

    t0 = time.perf_counter()
    model.eval()
    z_cvae = _batched_latents(model.latent, (mel, text, cond), cfg.batch_size,
                              dev)
    logger.log("latents", shape=list(z_cvae.shape),
               seconds=time.perf_counter() - t0)

    zd = torch.from_numpy(z_cvae).to(dev)
    km_cvae = kmeans(zd, n_classes, n_init=ccfg.kmeans_n_init, seed=ccfg.seed)
    if _writes(mesh):
        serving = save_serving_model(
            results_dir, model, km_cvae.centers,
            meta={"arch": "cvae", "latent_dim": cfg.latent_dim,
                  "text_dim": int(text.shape[1]),
                  "num_classes": int(n_classes),
                  "input_hw": [int(mel.shape[1]), int(mel.shape[2])],
                  "compute_dtype": str(cfg.compute_dtype),
                  "genre_names": [str(g) for g in genre_names],
                  "data_dir": str(data_dir)})
        logger.log("serving_saved", dir=str(serving),
                   n_centers=int(len(km_cvae.centers)))

    results = []
    eval_s = 0.0

    def row(method: str, feats) -> None:
        nonlocal eval_s
        t0 = time.perf_counter()
        m = evaluate_clustering(feats, y_genre, n_classes, ccfg.seed)
        eval_s += time.perf_counter() - t0
        m["Method"] = method
        results.append(m)

    row("CVAE (Multi-Modal)", zd)

    # PCA + KMeans on handcrafted (ref :419-426)
    hd = torch.from_numpy(handcrafted).to(dev)
    row("PCA + K-Means", pca_transform(hd, cfg.latent_dim))

    # Autoencoder + KMeans (ref :429-452: 50 epochs, Adam 1e-3, bs 32)
    t0 = time.perf_counter()
    ae = SimpleAutoencoder(
        input_dim=handcrafted.shape[1], latent_dim=cfg.latent_dim,
        generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    ae_fit = FitConfig(epochs=50, batch_size=32, patience=10**9, seed=cfg.seed)
    fit(create_state(ae, 1e-3), autoencoder_objective(), (hd,), ae_fit)
    ae.eval()
    with torch.no_grad():
        _, z_ae = ae(hd)
    logger.log("ae_baseline", seconds=time.perf_counter() - t0)
    row("Autoencoder + K-Means", z_ae)

    # "Direct Spectral" is KMeans on the raw handcrafted features (ref
    # :454-459, misnamed in the reference; kept for CSV parity)
    row("Direct Spectral", hd)
    logger.log("evaluate_clustering", seconds=eval_s, rows=len(results))

    df = pd.DataFrame(results)
    if _writes(mesh):
        consolidate_metrics(results_dir, df, "Conditional VAE",
                            per_arch_subdir="Conditional_VAE")
    logger.log("metrics", architecture="Conditional VAE",
               rows=df.to_dict("records"))

    if make_plots and _writes(mesh):
        # reconstruction of the first clip (ref :496-511): running
        # BatchNorm statistics, z sampled with the run's seed
        out = f"{results_dir}/Conditional_VAE"
        first = tuple(torch.from_numpy(np.array(a[:1])).to(dev)
                      for a in (mel, text, cond))
        with torch.no_grad():
            recon, _, _, _ = model(*first, generator=torch.Generator(
                device=dev).manual_seed(cfg.seed))
        reconstruction_pair(np.array(mel[:1])[0, :, :, 0],
                            recon.float().cpu().numpy()[0, :, :, 0],
                            f"{out}/reconstruction.png")
        xy = tsne(z_cvae, perplexity=ccfg.tsne_perplexity, seed=ccfg.seed,
                  device=dev)
        tsne_by_genre(xy, y_genre, genre_names,
                      f"{out}/cvae_latent_tsne_genre.png")
        y_lang, lang_names = encode_labels(data["metadata"]["language"].values)
        cluster_language_bar(km_cvae.labels, y_lang, lang_names,
                             f"{out}/cluster_lang_distribution.png")
    _done_writing(mesh)
    return df


# -----------------------------------------------------------------------------
# Hybrid VAE pipeline (≙ src/Convolutional_VAE.py)
# -----------------------------------------------------------------------------

def run_hybrid_vae(
    data_dir: str = "processed_data2",
    results_dir: str = "results",
    cfg: HybridVAEConfig = HybridVAEConfig(),
    ccfg: ClusterConfig = ClusterConfig(),
    logger: RunLogger | None = None,
    make_plots: bool = True,
    device: str = "cuda",
    mesh: MeshContext | None = None,
) -> pd.DataFrame:
    """Train the Hybrid VAE on ``data_dir`` (a ``processed_data2``), write
    its latents (``Convolutional_VAE/hybrid_latent_features.npy``, on every
    run), cluster them four ways and write the serving bundle and the four
    metric rows under ``results_dir``; with ``make_plots`` also the loss
    curve and the t-SNE triptych under ``Convolutional_VAE/``.  Returns the
    rows.

    Step for step as ``tpuvae/pipelines.py:822-958``: 85/15 split, fit on
    the validation loss with the per-dataset normaliser, batched latents,
    the k-means, Ward and DBSCAN sweeps, the ``arch="hybrid"`` bundle, the
    k = 2 "language" k-means, and Silhouette, Davies-Bouldin, ARI and the
    cluster count of each algorithm's labels.  ``device`` defaults to CUDA
    and raises without a card.  On the card every trunk forward launches
    kernel 6; each sweep and the rows launch kernel 5 once, and each row's
    Davies-Bouldin once more (its centroid distances), and the t-SNE 1,001
    times.  ``cfg.compute_dtype="bfloat16"`` computes in bfloat16 as
    :func:`run_conditional_vae`'s, and writes the latents file as the JAX
    pipeline's (raw bfloat16 bits, ``'<V2'``); with ``make_plots`` a
    missing matplotlib raises before any training.  ``mesh`` as
    :func:`run_simple_vae`'s, on the ``'sum'`` objective.
    """
    dtype = compute_dtype(cfg.compute_dtype)
    dev = _pipeline_device(device, mesh)
    if make_plots:
        pyplot()
    logger = logger or RunLogger()
    t_start = time.perf_counter()
    stream = bool(cfg.host_stream)
    data = load_advanced(data_dir, mmap=stream)
    mel = _mel_nhwc(data, stream)
    text = np.asarray(data["text"], np.float32)
    y_genre, genre_names = encode_labels(data["metadata"]["genre"].values)
    n_classes = len(genre_names)

    model = HybridVAE(
        latent_dim=cfg.latent_dim, text_dim=text.shape[1],
        input_hw=(mel.shape[1], mel.shape[2]),
        generator=torch.Generator().manual_seed(cfg.seed), dtype=dtype).to(dev)
    state = create_state(model, cfg.learning_rate)
    tr, va = train_val_split(len(mel), cfg.val_fraction, cfg.seed)
    fit_cfg = FitConfig(
        epochs=cfg.epochs, batch_size=cfg.batch_size, patience=cfg.patience,
        monitor="val", restore_best=False, loss_normalizer="per_dataset",
        seed=cfg.seed, log_every=1, scan_epochs=cfg.scan_epochs,
        host_stream=stream,
        **_ckpt_kwargs(cfg, f"{results_dir}/Convolutional_VAE/checkpoints"),
    )
    splits = _fit_splits(data, mel, (text,), (tr, va), stream, dev)
    t0 = time.perf_counter()
    logger.log("fit_start", setup_seconds=t0 - t_start, n_train=len(tr),
               n_val=len(va), host_stream=stream)
    res = fit(state, hybrid_objective(cfg.beta, cfg.text_loss_weight),
              splits[0], fit_cfg, val_data=splits[1], logger=logger,
              mesh=_fit_mesh(mesh, cfg.batch_size, logger),
              loss_reduction="sum")
    del splits
    logger.log("fit", seconds=time.perf_counter() - t0,
               epochs=len(res.history["train_loss"]),
               best_epoch=res.best_epoch, stopped_epoch=res.stopped_epoch,
               steps_per_sec=res.steps_per_sec, host_reads=res.host_reads,
               epoch_seconds=res.history["epoch_seconds"],
               train_loss=res.history["train_loss"],
               val_loss=res.history["val_loss"], lr=res.history["lr"])
    if make_plots and _writes(mesh):
        loss_curve(res.history["train_loss"],
                   f"{results_dir}/Convolutional_VAE/training_loss.png")

    t0 = time.perf_counter()
    model.eval()
    latents = _batched_latents(model.latent, (mel, text), cfg.batch_size, dev)
    # contract artifact: the reference saves it on EVERY run
    # (Convolutional_VAE.py:303), so it is not gated on plotting
    if _writes(mesh):
        out = Path(results_dir) / "Convolutional_VAE"
        out.mkdir(parents=True, exist_ok=True)
        save_latents(out / "hybrid_latent_features.npy", latents,
                     str(cfg.compute_dtype))
    logger.log("latents", shape=list(latents.shape),
               seconds=time.perf_counter() - t0)

    zd = torch.from_numpy(latents).to(dev)
    k_range = range(ccfg.hybrid_k_min, ccfg.hybrid_k_max + 1)
    sweep_s = {}
    t0 = time.perf_counter()
    km_sweep = kmeans_k_sweep(zd, k_range, n_init=ccfg.kmeans_n_init,
                              seed=ccfg.seed)
    sweep_s["kmeans"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    agg_sweep = agglomerative_k_sweep(zd, k_range)
    sweep_s["agglomerative"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eps_values = np.arange(ccfg.dbscan_eps_min, ccfg.dbscan_eps_max + 1e-9,
                           ccfg.dbscan_eps_step)
    db_sweep = dbscan_eps_sweep(zd, eps_values,
                                min_samples=ccfg.dbscan_min_samples,
                                fallback_eps=ccfg.dbscan_fallback_eps)
    sweep_s["dbscan"] = time.perf_counter() - t0
    logger.log("sweeps", kmeans_k=km_sweep.best_param,
               agg_k=agg_sweep.best_param, dbscan_eps=db_sweep.best_param,
               seconds=sweep_s)

    best_k = int(km_sweep.best_param)
    if _writes(mesh):
        serving = save_serving_model(
            results_dir, model,
            centers_from_labels(latents, km_sweep.best_labels),
            meta={"arch": "hybrid", "latent_dim": cfg.latent_dim,
                  "text_dim": int(text.shape[1]),
                  "input_hw": [int(mel.shape[1]), int(mel.shape[2])],
                  "compute_dtype": str(cfg.compute_dtype), "best_k": best_k,
                  "data_dir": str(data_dir)})
        logger.log("serving_saved", dir=str(serving), best_k=best_k)

    t0 = time.perf_counter()
    lang_km = kmeans(zd, 2, n_init=ccfg.kmeans_n_init, seed=ccfg.seed)
    algos = {
        f"K-Means-Main (k={best_k})": km_sweep.best_labels,
        "K-Means-Language (k=2)": lang_km.labels,
        f"Agglomerative (k={int(agg_sweep.best_param)})": agg_sweep.best_labels,
        f"DBSCAN (eps={float(db_sweep.best_param):.1f})": db_sweep.best_labels,
    }
    dist = self_distances(zd)
    rows = []
    for name, labels_pred in algos.items():
        n_found = len(set(labels_pred.tolist()) - {-1})
        if n_found > 1:
            lab, k = compact_labels(labels_pred)
            rows.append({
                "Algorithm": name,
                "Silhouette": float(silhouette_from_distances(dist, lab, k)),
                "Davies-Bouldin": float(davies_bouldin_score(zd, lab, k)),
                "ARI": adjusted_rand_score(y_genre, lab, n_classes, k),
                "n_clusters": n_found})
        else:  # ref :419-426
            rows.append({"Algorithm": name, "Silhouette": -1,
                         "Davies-Bouldin": -1, "ARI": -1,
                         "n_clusters": n_found})
    logger.log("rows", seconds=time.perf_counter() - t0, rows=len(rows))
    df = pd.DataFrame(rows)
    if _writes(mesh):
        consolidate_metrics(results_dir, df, "Convolutional VAE",
                            per_arch_subdir="Convolutional_VAE")
    logger.log("metrics", architecture="Convolutional VAE",
               rows=df.to_dict("records"))

    if make_plots and _writes(mesh):
        # no perplexity here, as in the JAX pipeline: t-SNE's default 30
        xy = tsne(latents, seed=ccfg.seed, device=dev)
        tsne_triptych(
            xy, algos[f"K-Means-Main (k={best_k})"],
            algos["K-Means-Language (k=2)"], y_genre, best_k,
            f"{results_dir}/Convolutional_VAE/tsne_clusters_v2.png")
    _done_writing(mesh)
    return df
