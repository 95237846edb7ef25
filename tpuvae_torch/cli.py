"""Command-line interface of the PyTorch port (``encode`` and ``serve``;
counterpart of those commands in ``tpuvae/cli.py``):

  python -m tpuvae_torch.cli encode --arch=simple song.wav [song2.wav ...]
  python -m tpuvae_torch.cli serve  --arch=simple --port=8787   # HTTP daemon

``encode`` maps NEW audio clips through a trained model to latents +
nearest-training-centroid cluster ids (serving bundle from a prior
``train-simple`` run).  Flags: ``--arch=simple``, ``--results_dir``,
``--data_dir`` (preprocessing dir with the scalers), ``--batch_size``,
``--out=<file.npz>`` to save latents/clusters, ``--device`` (default cuda).

``serve`` keeps a trained model resident behind a JSON HTTP API
(``GET /healthz``, ``GET /info``, ``POST /encode`` — see
:mod:`tpuvae_torch.serve`).  Flags: ``--arch``, ``--results_dir``,
``--data_dir``, ``--host`` (default 127.0.0.1), ``--port`` (default 8787),
``--warmup=0|1`` (one silent clip first, default 1), ``--batch_wait_ms``
(>0 micro-batches concurrent requests, default 0 = serialized),
``--max_batch`` (clips per device pass under micro-batching, default 32),
``--device`` (default cuda).

Both commands run on the card; without CUDA they stop with an error unless
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
    if cmd == "encode":
        import numpy as np

        from tpuvae_torch.infer import ClipEncoder

        eopts, paths = _parse_flags(
            cmd, rest, {"arch", "results_dir", "data_dir", "out",
                        "batch_size", "device"})
        if not paths:
            raise ValueError("encode needs at least one audio file")
        enc = ClipEncoder.load(
            eopts.get("arch", "simple"),
            results_dir=eopts.get("results_dir", "results"),
            data_dir=eopts.get("data_dir"),
            device=eopts.get("device", "cuda"),
        )
        res = enc.encode_paths(paths,
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
            arch=sopts.get("arch", "simple"),
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
                   f"'encode' and 'serve')")


if __name__ == "__main__":
    sys.exit(main())
