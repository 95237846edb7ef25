"""Checkpoints (counterpart of ``tpuvae/train/checkpoint.py``).

Two kinds:

* a weights checkpoint (:func:`save_checkpoint`): ``weights.npz`` (flax
  variables flattened to ``"params/..."`` / ``"batch_stats/..."`` keys) and
  ``metadata.json``; both read and write without flax, so
  ``tpuvae.train.checkpoint.load_checkpoint`` reads what the port writes
  and the reverse.  :mod:`tpuvae_torch.convert` maps the flat dict onto the
  port's modules.  ``fit`` writes the best weights this way (``best/``);
* a full training state (:func:`save_train_state`, rotated by
  :class:`CheckpointManager`): ``train_state.pt`` holds the module's
  ``state_dict``, the optimizer's, the step count and the fit loop's
  ``torch.Generator`` state, beside ``metadata.json`` with the loop's
  counters.  It is the port's own format: the JAX package's
  ``train_state.msgpack`` needs flax to read, and a resume across packages
  would continue on another RNG.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from tpuvae_torch.convert import to_flax
from tpuvae_torch.train.state import TrainState, load_optimizer_state

STATE_FILE = "train_state.pt"


def load_checkpoint(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """``(flat variables, metadata)`` of the checkpoint at ``path``."""
    path = Path(path)
    with np.load(path / "weights.npz") as z:
        flat = {k: z[k] for k in z.files}
    metadata = json.loads((path / "metadata.json").read_text())
    return flat, metadata


def save_checkpoint(path: str | Path, model: nn.Module | dict,
                    metadata: dict | None = None) -> None:
    """Write a model's weights and BatchNorm statistics (or a ``state_dict``
    of one) in the flax layout, and ``metadata``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    np.savez(path / "weights.npz", **to_flax(sd))
    (path / "metadata.json").write_text(json.dumps(metadata or {}, default=str))


def optimizer_steps(state: TrainState) -> int:
    """Optimizer steps taken so far (Adam's per-parameter count)."""
    for s in state.optimizer.state.values():
        if "step" in s:
            return int(s["step"])
    return 0


def save_train_state(path: str | Path, state: TrainState,
                     metadata: dict[str, Any] | None = None, *,
                     generator: torch.Generator | None = None) -> None:
    """Full training checkpoint: weights, BatchNorm statistics, optimizer
    state, step and ``generator``'s state, restorable for an exact
    resume."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": optimizer_steps(state),
        "generator": None if generator is None else generator.get_state(),
    }, path / STATE_FILE)
    (path / "metadata.json").write_text(json.dumps(metadata or {}, default=str))


def restore_train_state(path: str | Path, state: TrainState, *,
                        generator: torch.Generator | None = None):
    """Restore a full training checkpoint onto a freshly built ``state``
    (same model and optimizer) and, when given, ``generator``.  Returns
    ``(state, metadata)``."""
    path = Path(path)
    # on the host: a generator's state is a CPU byte tensor whatever its
    # device, and load_state_dict moves the rest to the parameters' device
    saved = torch.load(path / STATE_FILE, map_location="cpu",
                       weights_only=True)
    state.model.load_state_dict(saved["model"])
    load_optimizer_state(state.optimizer, saved["optimizer"])
    if generator is not None:
        if saved["generator"] is None:
            raise ValueError(f"{path} holds no generator state")
        generator.set_state(saved["generator"])
    metadata = json.loads((path / "metadata.json").read_text())
    return state, metadata


class CheckpointManager:
    """Rotating full-train-state checkpoints with atomic writes.

    Layout under ``directory``::

        step_00000049/train_state.pt + metadata.json
        step_00000099/...
        latest -> step_00000099        (symlink; LATEST text file fallback)

    The ``max_to_keep`` newest step directories are kept; older ones are
    pruned after each save.  A save goes to a hidden temporary directory
    first and is ``os.replace``-renamed into place, so a crash mid-save
    never corrupts the newest restorable checkpoint.
    """

    def __init__(self, directory: str | Path, max_to_keep: int = 1):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = Path(directory)
        self.max_to_keep = int(max_to_keep)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{int(step):08d}"

    def steps(self) -> list[int]:
        out = []
        for p in self.directory.glob("step_*"):
            if p.is_dir() and (p / STATE_FILE).exists():
                try:
                    out.append(int(p.name.split("_", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, metadata: dict[str, Any] | None = None,
             *, step: int | None = None,
             generator: torch.Generator | None = None) -> Path:
        step = optimizer_steps(state) if step is None else int(step)
        tmp = self.directory / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        save_train_state(tmp, state, metadata, generator=generator)
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._update_latest(final)
        self._prune()
        return final

    def restore(self, state: TrainState, step: int | None = None, *,
                generator: torch.Generator | None = None):
        """Restore ``(state, metadata)`` from ``step`` (default: newest)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        return restore_train_state(self._step_dir(step), state,
                                   generator=generator)

    def _update_latest(self, target: Path) -> None:
        link = self.directory / "latest"
        # a real 'latest' directory is replaced only when it holds one of
        # these checkpoints; anything else is left alone
        if link.is_dir() and not link.is_symlink():
            if (link / STATE_FILE).exists():
                shutil.rmtree(link)
            else:
                (self.directory / "LATEST").write_text(target.name)
                return
        try:
            tmp_link = self.directory / ".latest.tmp"
            if tmp_link.is_symlink() or tmp_link.exists():
                tmp_link.unlink()
            os.symlink(target.name, tmp_link)
            os.replace(tmp_link, link)
        except OSError:
            (self.directory / "LATEST").write_text(target.name)

    def _prune(self) -> None:
        for step in self.steps()[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)


def latest_train_state_dir(directory: str | Path) -> Path | None:
    """The directory to resume from, across all layouts: a real ``latest``
    directory, the rotation symlink, the ``LATEST`` pointer file, or the
    highest ``step_*`` directory.  None when nothing restorable exists."""
    directory = Path(directory)
    ck = directory / "latest"
    if (ck / STATE_FILE).exists():      # a directory or a valid symlink
        return ck
    pointer = directory / "LATEST"
    if pointer.exists():
        cand = directory / pointer.read_text().strip()
        if (cand / STATE_FILE).exists():
            return cand
    if directory.exists():
        steps = CheckpointManager(directory).steps()
        if steps:
            return directory / f"step_{steps[-1]:08d}"
    return None
