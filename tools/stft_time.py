#!/usr/bin/env python3
"""Time kernel 1 (the fused STFT of ``tpuvae_torch``) through its public
wrapper at given geometries, on one GPU, optionally against another
checkout of the repository in alternating processes.

    python3 tools/stft_time.py                           # this checkout
    python3 tools/stft_time.py --geometries 2048/512,1024/256 --clips 32
    python3 tools/stft_time.py --old DIR                 # DIR, this, this, DIR

``DIR`` is the root of another checkout (e.g. a parent commit unpacked with
``git archive`` into a git-ignored directory); each run is its own process,
which builds that checkout's kernels at first use and times
``stft_fused_features(y, n_fft, hop, sr=22050, n_mels=128)`` in fast mode
on seeded tones of 30 s (median of ``--runs`` CUDA-event timings, L2
flushed before each, as ``chip_smoke.time_ms``).  Prints the card's name
and power limit, then one JSON line per run: ``{"tree": ..., "ms": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def time_tree(root: Path, geometries, clips: int, runs: int) -> dict:
    """Times of the checkout at ``root`` (imported from there)."""
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(REPO))
    import torch

    import chip_smoke as cs
    from tpuvae_torch.ops.stft import stft_fused_features

    dev = torch.device("cuda")
    y = torch.from_numpy(cs.tones(clips, int(cs.SR * cs.DURATION), 3)).to(dev)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)
    out = {}
    for n_fft, hop in geometries:
        out[f"{n_fft}/{hop}"] = cs.time_ms(
            torch, lambda: stft_fused_features(y, n_fft, hop, sr=cs.SR,
                                               n_mels=cs.N_MELS), flush,
            runs=runs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--geometries", default="2048/512",
                    help="comma-separated n_fft/hop pairs")
    ap.add_argument("--clips", type=int, default=32)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--old", type=Path, default=None,
                    help="another checkout, timed before and after this one")
    ap.add_argument("--tree", type=Path, default=REPO, help=argparse.SUPPRESS)
    args = ap.parse_args()
    geometries = [tuple(int(v) for v in g.split("/"))
                  for g in args.geometries.split(",")]
    if args.old is None or args.tree != REPO:
        ms = time_tree(args.tree.resolve(), geometries, args.clips, args.runs)
        print(json.dumps({"tree": str(args.tree), "ms": ms}), flush=True)
        return 0
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    print(f"card: {cs.card_line()}", flush=True)
    old = args.old.resolve()
    for tree in (old, REPO, REPO, old):
        cmd = [sys.executable, __file__, "--geometries", args.geometries,
               "--clips", str(args.clips), "--runs", str(args.runs),
               "--tree", str(tree)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
