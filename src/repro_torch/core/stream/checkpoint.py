"""Checkpoint and restore of the streaming monitor: bitwise resume.

The counterpart of :mod:`repro.core.stream.checkpoint`, on the same
layout, byte for byte (:mod:`repro_torch.ckpt.checkpoint`)::

    <root>/step_<epoch>/
      manifest.json                       — shapes, dtypes, monitor meta
      monitor__state.energy_corr_j.npy    — one array per schema field
      ...

The array set and the meta are :mod:`.schema`'s.  A checkpoint written by
the port (``"backend": "torch"`` in its meta) restores in the reference
(``restore_monitor(root, backend="numpy")``), and one the reference wrote
restores here, whatever its ``backend``: this is how a monitor's state
crosses between the two packages.  A monitor restored at a slab boundary
and fed the remaining slabs answers every query bitwise as one that never
stopped.

Failure typing: a checkpoint that exists but cannot be read back — a
truncated or corrupt ``.npy``, a garbled or partial manifest, a manifest
entry whose file is missing — raises :class:`CheckpointError`.  One that
is not there (no root, unknown step) raises
:class:`MissingCheckpointError`, both a ``CheckpointError`` and a
``FileNotFoundError``.  ``restore_monitor(..., fallback=True)`` restores
the newest complete generation when newer ones are unreadable.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch._device import DeviceLike
from repro_torch.ckpt.checkpoint import CheckpointManager, steps_in
from repro_torch.core.stream.schema import pack_monitor, unpack_monitor

_TREE = "monitor"

# one manager (one writer thread, one retain-GC sequence) per checkpoint
# root: saves to one root queue up instead of collecting each other's
# steps out of order
_managers: Dict[str, CheckpointManager] = {}


class CheckpointError(RuntimeError):
    """A monitor checkpoint exists but cannot be read back (truncated
    ``.npy``, garbled manifest, missing manifest entries, partial
    write)."""


class MissingCheckpointError(CheckpointError, FileNotFoundError):
    """No checkpoint to read (missing root or unknown step)."""


def _manager(root: str, retain: int) -> CheckpointManager:
    key = os.path.abspath(root)
    mgr = _managers.get(key)
    if mgr is None or mgr.retain != retain:
        if mgr is not None:
            mgr.wait()
        mgr = CheckpointManager(root, retain=retain)
        _managers[key] = mgr
    return mgr


def save_monitor(monitor, root: str, *, step: Optional[int] = None,
                 retain: int = 3, asynchronous: bool = False,
                 extras: Optional[Dict[str, Any]] = None
                 ) -> CheckpointManager:
    """Write one checkpoint of ``monitor`` under ``root`` and return the
    :class:`~repro_torch.ckpt.checkpoint.CheckpointManager` used (call its
    ``wait()`` after an ``asynchronous`` save before relying on it).

    ``step`` defaults to the monitor's ingest epoch.  The state comes off
    the card before this returns, so ingestion may go on at once while an
    asynchronous write drains.  ``extras`` adds JSON-able keys to the
    manifest meta (a supervisor's slab cursor); they must not collide
    with the schema's own keys."""
    arrays, meta = pack_monitor(monitor)
    if extras:
        clash = sorted(set(extras) & set(meta))
        if clash:
            raise ValueError(f"extras keys collide with schema meta: "
                             f"{clash}")
        meta = {**meta, **extras}
    if step is None:
        step = int(meta["epoch"])
    mgr = _manager(root, retain)
    if asynchronous:
        mgr.save_async(step, {_TREE: arrays}, extras=meta)
    else:
        mgr.save(step, {_TREE: arrays}, extras=meta)
    return mgr


def checkpoint_steps(root: str):
    """Completed checkpoint steps under ``root``, ascending."""
    return steps_in(root)


def _load_step(root: str, step: int
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """One generation's arrays and meta, every partial-write failure
    typed as :class:`CheckpointError`."""
    d = os.path.join(root, f"step_{step}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except FileNotFoundError as exc:
        raise CheckpointError(
            f"step_{step}: manifest.json missing (partial write?)"
        ) from exc
    except (OSError, json.JSONDecodeError) as exc:
        raise CheckpointError(
            f"step_{step}: unreadable manifest.json: {exc}") from exc
    try:
        entries = manifest["trees"][_TREE]
        meta = manifest["extras"]
    except (KeyError, TypeError) as exc:
        raise CheckpointError(
            f"step_{step}: manifest has no '{exc}' entry — not a "
            f"monitor checkpoint, or a garbled manifest") from exc
    arrays = {}
    for path, e in entries.items():
        try:
            fname = e["file"]
        except (KeyError, TypeError) as exc:
            raise CheckpointError(
                f"step_{step}: manifest entry for '{path}' has no "
                f"file reference") from exc
        try:
            arrays[path] = np.load(os.path.join(d, fname))
        except FileNotFoundError as exc:
            raise CheckpointError(
                f"step_{step}: array file '{fname}' missing "
                f"(partial write?)") from exc
        except (OSError, ValueError, EOFError, KeyError) as exc:
            raise CheckpointError(
                f"step_{step}: array file '{fname}' is truncated or "
                f"corrupt: {exc}") from exc
    return arrays, meta


def restore_monitor(root: str, *, step: Optional[int] = None,
                    device: DeviceLike = "cuda", fallback: bool = False,
                    with_meta: bool = False):
    """Rebuild a :class:`~.monitor.MonitorService` on ``device`` from the
    checkpoint at ``step`` (default: the latest), bitwise.

    With ``fallback=True`` (and no ``step``), unreadable generations are
    skipped newest first and the newest complete one restores; only if
    every retained generation is unreadable does a
    :class:`CheckpointError` list each one's failure.
    ``with_meta=True`` returns ``(monitor, meta)``, the manifest meta with
    any ``extras`` saved beside it."""
    steps = checkpoint_steps(root)
    if not steps:
        raise MissingCheckpointError(f"no checkpoints under {root}")
    if step is None:
        candidates = steps[::-1] if fallback else [steps[-1]]
    elif step not in steps:
        raise MissingCheckpointError(
            f"no checkpoint step_{step} under {root}; have {steps}")
    else:
        candidates = [step]
    failures = []
    for s in candidates:
        try:
            arrays, meta = _load_step(root, s)
        except CheckpointError as exc:
            failures.append(str(exc))
            continue
        mon = unpack_monitor(arrays, meta, device=device)
        return (mon, meta) if with_meta else mon
    raise CheckpointError(
        "no readable checkpoint generation under "
        f"{root}: {'; '.join(failures)}")
