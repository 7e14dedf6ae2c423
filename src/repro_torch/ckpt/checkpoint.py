"""Checkpoint storage: one directory a step, a manifest and one ``.npy`` a
leaf, written atomically, old steps garbage-collected.

The port's own copy of the part of :mod:`repro.ckpt.checkpoint` that
monitor checkpoints use, writing the same layout::

    <root>/step_<N>/
      manifest.json          — {"step", "extras", "trees": {tree: {path:
                               {"file", "shape", "dtype"}}}}
      <tree>__<path>.npy     — one file a leaf

Leaves are numpy arrays already on the host (the caller copies them off
the card); nothing here touches a device.  Writes go to
``step_<N>.tmp`` and are renamed on completion, so a reader never sees a
partial step; after each save only the newest ``retain`` steps are kept.
``save_async`` writes on one background thread at a time: a second save
waits for the first, so saves to one manager queue up and never race.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional

import numpy as np


def _leaf_fname(path: str) -> str:
    return path.replace("/", "_") + ".npy"


def steps_in(root: str) -> List[int]:
    """Completed steps under ``root``, ascending (none if it is absent)."""
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


class CheckpointManager:
    """Saves of numpy leaves under one ``root`` (see the module doc)."""

    def __init__(self, root: str, retain: int = 3):
        if retain < 1:
            raise ValueError("retain must be >= 1")
        self.root = root
        self.retain = int(retain)
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def steps(self) -> List[int]:
        return steps_in(self.root)

    # -- save ---------------------------------------------------------------
    def _write(self, step: int, trees: Mapping[str, Mapping[str, Any]],
               extras: Dict[str, Any]) -> None:
        final = os.path.join(self.root, f"step_{step}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Any] = {"step": step, "extras": extras,
                                    "trees": {}}
        for tree_name, leaves in trees.items():
            entries = {}
            # sorted paths: the reference's flattening order
            for path in sorted(leaves):
                arr = np.asarray(leaves[path])
                fname = f"{tree_name}__{_leaf_fname(path)}"
                np.save(os.path.join(tmp, fname), arr)
                entries[path] = {"file": fname, "shape": list(arr.shape),
                                 "dtype": str(arr.dtype)}
            manifest["trees"][tree_name] = entries
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _write_recorded(self, step, trees, extras) -> None:
        try:
            self._write(step, trees, extras)
        except Exception as exc:            # re-raised by wait()
            self._error = exc

    def _gc(self) -> None:
        for s in self.steps()[:-self.retain]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"),
                          ignore_errors=True)

    def save(self, step: int, trees: Mapping[str, Mapping[str, Any]],
             extras: Optional[Dict[str, Any]] = None) -> None:
        """Write ``trees`` (``{tree: {path: ndarray}}``) as ``step`` now,
        after any save still in flight."""
        self.wait()
        self._write(step, trees, dict(extras or {}))

    def save_async(self, step: int, trees: Mapping[str, Mapping[str, Any]],
                   extras: Optional[Dict[str, Any]] = None) -> None:
        """Write ``trees`` as ``step`` on a background thread, after any
        save still in flight.  The arrays must not change until
        :meth:`wait` returns: pass copies."""
        self.wait()
        self._thread = threading.Thread(
            target=self._write_recorded,
            args=(step, trees, dict(extras or {})), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the background save, if any, has finished; raise
        what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc
