"""HTTP serving daemon: a trained model behind a JSON API
(counterpart of ``tpuvae/serve.py``).

Keeps the bundle loaded and the kernels built, so requests pay neither::

    python -m tpuvae_torch.cli serve --arch=hybrid --port=8787

    curl localhost:8787/healthz
    curl -X POST localhost:8787/encode \
         -d '{"paths": ["new_song.wav"], "lyrics": ["la la"]}'

Endpoints (all JSON):

- ``GET /healthz`` — liveness + bundle identity (arch, latent_dim, torch
  device).
- ``GET /info`` — serving metadata (preprocess geometry, genres, centroid
  count, lyrics-embedder backend).
- ``POST /encode`` — body ``{"paths": [...]}`` for server-local files or
  ``{"audio_b64": [...]}`` for base64 WAV or FLAC container bytes; optional
  ``"lyrics"`` (cvae / hybrid), ``"genres"`` (cvae), ``"batch_size"``.
  Returns ``{"latents": [[...]], "clusters": [...], "warnings": [...]}``.

Requests are served from a thread pool (stdlib ``ThreadingHTTPServer``);
health checks stay responsive while encodes run.  The device pass is
serialized — by default on one lock (in-order), or through
:class:`MicroBatcher` (``batch_wait_ms > 0``), which coalesces concurrent
requests into shared device batches.  Built on the standard library only.
"""

from __future__ import annotations

import base64
import binascii
import json
import tempfile
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from tpuvae_torch.infer import ClipEncoder, EncodeResult

# container bytes per clip are ~5 MB at reference geometry (30 s, 22 kHz,
# 16-bit); 256 MB comfortably bounds a 32-clip base64 batch
MAX_BODY_BYTES = 256 * 1024 * 1024

# warnings.catch_warnings mutates process-global state and is documented
# thread-unsafe; every recording block in this module serializes on this
# lock so concurrent requests can't misattribute (or permanently swallow)
# each other's warnings
_WARN_LOCK = threading.Lock()

_MAGIC_SUFFIX = {b"fLaC": ".flac", b"RIFF": ".wav"}


class RequestError(ValueError):
    """A client error with an HTTP status."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


def _decode_b64_clips(blobs, tmp_dir: str) -> list[str]:
    """Write base64 container bytes to ``tmp_dir`` files ``load_audio`` can
    dispatch on (WAV or FLAC, by magic; MP3 uploads are refused, as in the
    JAX package)."""
    paths = []
    for i, blob in enumerate(blobs):
        if not isinstance(blob, str):
            raise RequestError(f"audio_b64[{i}] must be a base64 string")
        try:
            raw = base64.b64decode(blob, validate=True)
        except binascii.Error as e:
            raise RequestError(f"audio_b64[{i}] is not valid base64: {e}")
        suffix = _MAGIC_SUFFIX.get(raw[:4])
        if suffix is None:
            raise RequestError(
                f"audio_b64[{i}] is not a WAV/FLAC container "
                f"(magic {raw[:4]!r})")
        p = Path(tmp_dir) / f"clip_{i:05d}{suffix}"
        p.write_bytes(raw)
        paths.append(str(p))
    return paths


class _Pending:
    """One submitted encode request, waiting on its batch to execute."""

    __slots__ = ("waveforms", "lyrics", "genres", "event", "result",
                 "warnings", "error")

    def __init__(self, waveforms, lyrics, genres):
        self.waveforms = waveforms
        self.lyrics = lyrics
        self.genres = genres
        self.event = threading.Event()
        self.result = None
        self.warnings: list[str] = []
        self.error: Exception | None = None


class MicroBatcher:
    """Coalesce concurrent encode requests into shared device batches.

    K concurrent single-clip requests served one-by-one cost K device
    passes, each with its own kernel launches; merged, they share one.  A single worker thread drains a
    queue: the first request opens a window that closes after
    ``max_wait_ms`` or when ``max_batch`` clips are gathered, whichever is
    first.  Only requests with the same modality signature (lyrics given?
    genres given?) merge, so per-request warning/validation semantics stay
    identical to unbatched calls; arguments are validated at submit time
    (:meth:`ClipEncoder.validate_args`) so one bad request can't fail a
    merged batch.
    """

    def __init__(self, encoder: ClipEncoder, max_batch: int = 32,
                 max_wait_ms: float = 20.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.encoder = encoder
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._closed = False
        self.batches_run = 0
        self.requests_batched = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpuvae-torch-microbatch")
        self._thread.start()

    def encode_waveforms(self, waveforms, lyrics=None, genres=None):
        """Submit and block until the batch containing this request ran.
        Returns ``(EncodeResult, warning_strings)``; re-raises encode
        errors."""
        waveforms = np.asarray(waveforms, np.float32)
        self.encoder.validate_args(len(waveforms), lyrics=lyrics,
                                   genres=genres)
        req = _Pending(waveforms, lyrics, genres)
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append(req)
            self._cv.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result, req.warnings

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests; the worker drains the queue, then exits."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)

    # -- worker --------------------------------------------------------------

    @staticmethod
    def _sig(r: _Pending):
        # waveform geometry keys the merge too: mixed-length requests must
        # never concatenate (the whole merged batch would fail on the one
        # wrong-length request)
        return (r.lyrics is None, r.genres is None, r.waveforms.shape[1:])

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:          # closed and drained
                    return
                first = self._queue.pop(0)
                sig = self._sig(first)
                batch, total = [first], len(first.waveforms)
                deadline = time.monotonic() + self.max_wait
                while total < self.max_batch:
                    i = next(
                        (j for j, r in enumerate(self._queue)
                         if self._sig(r) == sig
                         and total + len(r.waveforms) <= self.max_batch),
                        None)
                    if i is not None:
                        r = self._queue.pop(i)
                        batch.append(r)
                        total += len(r.waveforms)
                        continue
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(remaining)
            self._execute(batch)

    def _execute(self, batch: list[_Pending]):
        try:
            waves = np.concatenate([r.waveforms for r in batch])
            lyrics = genres = None
            if batch[0].lyrics is not None:
                lyrics = [l for r in batch for l in r.lyrics]
            if batch[0].genres is not None:
                genres = [g for r in batch for g in r.genres]
            with _WARN_LOCK, warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = self.encoder.encode_waveforms(
                    waves, lyrics=lyrics, genres=genres,
                    batch_size=self.max_batch)
            msgs = [str(w.message) for w in caught]
            self.batches_run += 1
            self.requests_batched += len(batch)
            off = 0
            for r in batch:
                k = len(r.waveforms)
                r.result = EncodeResult(
                    latents=res.latents[off:off + k],
                    clusters=res.clusters[off:off + k], paths=[])
                r.warnings = msgs
                off += k
        except Exception as e:             # noqa: BLE001 — delivered per-request
            for r in batch:
                r.error = e
        finally:
            for r in batch:
                r.event.set()


class ServingApp:
    """The encoder + request handling, independent of the HTTP plumbing."""

    def __init__(self, encoder: ClipEncoder,
                 batcher: MicroBatcher | None = None):
        self.encoder = encoder
        self.batcher = batcher
        self._encode_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._requests_served = 0

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()

    # -- GET ---------------------------------------------------------------

    def healthz(self) -> dict:
        out = {
            "status": "ok",
            "arch": self.encoder.arch,
            "latent_dim": int(self.encoder.meta["latent_dim"]),
            "device": str(self.encoder.device),
            "requests_served": self._requests_served,
        }
        if self.batcher is not None:
            out["microbatch"] = {
                "max_batch": self.batcher.max_batch,
                "max_wait_ms": self.batcher.max_wait * 1e3,
                "batches_run": self.batcher.batches_run,
                "requests_batched": self.batcher.requests_batched,
            }
        return out

    def info(self) -> dict:
        enc = self.encoder
        cfg = enc.pre_cfg
        return {
            "arch": enc.arch,
            "latent_dim": int(enc.meta["latent_dim"]),
            "n_centers": 0 if enc.centers is None else int(len(enc.centers)),
            "sample_rate": cfg.sample_rate,
            "duration": cfg.duration,
            "num_samples": int(cfg.sample_rate * cfg.duration),
            "genre_names": list(enc.meta.get("genre_names", [])),
            "lyrics_embedder_backend": enc.embed_backend,
            "model_meta": {k: v for k, v in enc.meta.items()
                           if isinstance(v, (str, int, float, bool))},
        }

    # -- POST /encode --------------------------------------------------------

    def encode(self, body: dict) -> dict:
        unknown = set(body) - {"paths", "audio_b64", "lyrics", "genres",
                               "batch_size"}
        if unknown:
            raise RequestError(f"unknown field(s) {sorted(unknown)}")
        paths = body.get("paths")
        blobs = body.get("audio_b64")
        if (paths is None) == (blobs is None):
            raise RequestError(
                "exactly one of 'paths' (server-local files) or 'audio_b64' "
                "(base64 WAV/FLAC bytes) is required")
        for key in ("paths", "audio_b64", "lyrics", "genres"):
            if body.get(key) is not None and not isinstance(body[key], list):
                raise RequestError(f"'{key}' must be a list")
        batch_size = body.get("batch_size", 32)
        if not isinstance(batch_size, int) or batch_size < 1:
            raise RequestError("'batch_size' must be a positive integer")

        if paths is not None and not paths:
            raise RequestError("'paths' is empty")
        if blobs is not None and not blobs:
            raise RequestError("'audio_b64' is empty")
        if paths is not None:
            missing = [p for p in paths if not Path(p).exists()]
            if missing:
                raise RequestError(f"no such file(s): {missing}", status=404)
        kwargs = dict(lyrics=body.get("lyrics"), genres=body.get("genres"))

        # container decode runs here, concurrently per handler thread —
        # only the device pass needs serialization (lock or batch worker)
        if paths is not None:
            waves = self.encoder.load_waveforms(paths)
        else:
            with tempfile.TemporaryDirectory(prefix="tpuvae_torch_serve_") as td:
                waves = self.encoder.load_waveforms(
                    _decode_b64_clips(blobs, td))

        if self.batcher is not None:
            # batch_size is accepted for API compat; the server's max_batch
            # governs the device batch
            res, warn_msgs = self.batcher.encode_waveforms(waves, **kwargs)
        else:
            with self._encode_lock, _WARN_LOCK, \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = self.encoder.encode_waveforms(
                    waves, batch_size=batch_size, **kwargs)
            warn_msgs = [str(w.message) for w in caught]
        res.paths = paths or []
        with self._stats_lock:
            self._requests_served += 1
        return {
            "latents": np.asarray(res.latents, np.float64).round(7).tolist(),
            "clusters": [int(c) for c in res.clusters],
            "paths": res.paths,
            "warnings": warn_msgs,
        }


def _make_handler(app: ServingApp, quiet: bool):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # noqa: N802 (stdlib name)
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        def _reply(self, status: int, payload: dict, close: bool = False):
            # close=True for error replies sent WITHOUT reading the request
            # body: on a keep-alive (HTTP/1.1) connection the unread bytes
            # would be parsed as the start of the next request
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if close:
                self.close_connection = True
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):   # noqa: N802
            if self.path in ("/healthz", "/health"):
                self._reply(200, app.healthz())
            elif self.path == "/info":
                self._reply(200, app.info())
            else:
                self._reply(404, {"error": f"no route {self.path!r}; GET "
                                           f"/healthz, /info or POST /encode"})

        def do_POST(self):   # noqa: N802
            if self.path != "/encode":
                self._reply(404, {"error": f"no route {self.path!r}"},
                            close=True)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": f"body of {length} bytes "
                                      f"exceeds the {MAX_BODY_BYTES}-byte "
                                      f"limit"}, close=True)
                    return
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    raise RequestError(f"body is not valid JSON: {e}")
                if not isinstance(body, dict):
                    raise RequestError("body must be a JSON object")
                self._reply(200, app.encode(body))
            except RequestError as e:
                self._reply(e.status, {"error": str(e)})
            except (ValueError, KeyError) as e:
                # ClipEncoder argument errors (bad genre, lyric count, ...)
                self._reply(400, {"error": str(e)})
            except Exception as e:   # keep the daemon alive
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(encoder: ClipEncoder, host: str = "127.0.0.1", port: int = 0,
                quiet: bool = False, batch_wait_ms: float = 0.0,
                max_batch: int = 32) -> ThreadingHTTPServer:
    """Bind (but don't start) the HTTP server; ``port=0`` picks a free port
    (``server.server_address[1]``).  Call ``serve_forever()`` on the result,
    or run it in a thread for tests.  ``batch_wait_ms > 0`` enables request
    micro-batching (:class:`MicroBatcher`): concurrent ``/encode`` calls
    within that window share one ``max_batch``-row device pass.  Call
    ``server.app.close()`` after ``server_close()`` to stop the worker."""
    batcher = (MicroBatcher(encoder, max_batch=max_batch,
                            max_wait_ms=batch_wait_ms)
               if batch_wait_ms > 0 else None)
    app = ServingApp(encoder, batcher=batcher)
    server = ThreadingHTTPServer((host, port), _make_handler(app, quiet))
    server.app = app
    return server


def serve(arch: str = "hybrid", results_dir: str = "results",
          data_dir: str | None = None, host: str = "127.0.0.1",
          port: int = 8787, warmup: bool = True,
          batch_wait_ms: float = 0.0, max_batch: int = 32,
          device: str = "cuda") -> None:
    """Load the bundle, optionally warm up (kernel build + first launch)
    with one silent clip, then serve forever (the ``cli serve`` entry
    point)."""
    encoder = ClipEncoder.load(arch, results_dir=results_dir,
                               data_dir=data_dir, device=device)
    if warmup:
        n = int(encoder.pre_cfg.sample_rate * encoder.pre_cfg.duration)
        kwargs = {} if arch == "simple" else {"lyrics": [" "]}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # cvae: the zero condition
            encoder.encode_waveforms(np.zeros((1, n), np.float32), **kwargs)
        print("warmup done")
    server = make_server(encoder, host=host, port=port,
                         batch_wait_ms=batch_wait_ms, max_batch=max_batch)
    mode = (f"micro-batching ({batch_wait_ms:g} ms window, "
            f"max {max_batch} clips)" if batch_wait_ms > 0 else "serialized")
    print(f"serving arch={arch!r} on {encoder.device} at http://{host}:"
          f"{server.server_address[1]}  (GET /healthz, /info; POST /encode; "
          f"encodes {mode})", flush=True)

    # graceful SIGTERM (the container-stop signal): finish in-flight
    # requests, then exit 0 — serve_forever returns after shutdown().
    # Handlers can only be installed on the main thread.
    import signal

    def _term(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    on_main = threading.current_thread() is threading.main_thread()
    prev = signal.signal(signal.SIGTERM, _term) if on_main else None
    try:
        server.serve_forever()
        print("shutdown requested; drained in-flight requests", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        if on_main:
            signal.signal(signal.SIGTERM, prev)
        server.server_close()
        server.app.close()
