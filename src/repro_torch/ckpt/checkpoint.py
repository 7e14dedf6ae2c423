"""Checkpoint storage: one directory a step, a manifest and one ``.npy`` a
leaf, written atomically, old steps garbage-collected.

The port's own copy of :mod:`repro.ckpt.checkpoint`, which monitor
checkpoints and the training loop use, writing the same layout::

    <root>/step_<N>/
      manifest.json          — {"step", "extras", "trees": {tree: {path:
                               {"file", "shape", "dtype"}}}}
      <tree>__<path>.npy     — one file a leaf

Leaves are numpy arrays already on the host (the caller copies them off
the card, :func:`snapshot` for a tree of tensors); a bf16 leaf is stored
as f32 under its logical type ``bfloat16``, as the reference stores it.
:meth:`CheckpointManager.restore` reads a step back into a tree of
tensors, on the tree's device and in its types.  Writes go to
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
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.tree import flatten_with_paths, map_with_paths


def _leaf_fname(path: str) -> str:
    return path.replace("/", "_") + ".npy"


class Stored(NamedTuple):
    """A leaf kept in another numpy type than its own: bf16 values, which
    numpy cannot hold, as f32 (exactly) under the logical type
    ``"bfloat16"``."""
    array: np.ndarray
    dtype: str


def snapshot(tree: Any) -> Dict[str, Any]:
    """``{dotted path: numpy copy}`` of a tree of tensors (the reference's
    paths, :func:`repro_torch.common.tree.flatten_with_paths`), copied to
    the host now, so a background save may write it while the tensors
    change; bf16 leaves as :class:`Stored` f32."""
    out: Dict[str, Any] = {}
    for path, leaf in flatten_with_paths(tree):
        t = torch.as_tensor(leaf).detach()
        if t.dtype == torch.bfloat16:
            out[path] = Stored(t.float().cpu().numpy(), "bfloat16")
        else:
            out[path] = t.cpu().numpy().copy()
    return out


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

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

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
                leaf = leaves[path]
                if isinstance(leaf, Stored):
                    arr, logical = leaf.array, leaf.dtype
                else:
                    arr = np.asarray(leaf)
                    logical = str(arr.dtype)
                fname = f"{tree_name}__{_leaf_fname(path)}"
                np.save(os.path.join(tmp, fname), arr)
                entries[path] = {"file": fname, "shape": list(arr.shape),
                                 "dtype": logical}
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

    # -- restore -------------------------------------------------------------
    def restore(self, step: int, tree_specs: Mapping[str, Any],
                device: Optional[torch.device] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Rebuild each tree of ``tree_specs`` (``{tree: tree of specs}``)
        from step ``step``: returns (``{tree: tree of tensors}``, the
        step's extras).  A spec leaf is a tensor (its shape, type and
        device) or has ``shape`` and ``dtype`` (a
        :class:`~repro_torch.common.spec.TensorSpec`; placed on
        ``device``, default the CPU).  Leaves are matched by the
        reference's dotted paths; a stored shape other than the spec's
        raises ``ValueError``."""
        d = os.path.join(self.root, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out: Dict[str, Any] = {}
        for name, spec_tree in tree_specs.items():
            entries = manifest["trees"][name]

            def leaf(path, spec):
                path = ".".join(map(str, path))
                arr = np.load(os.path.join(d, entries[path]["file"]))
                if tuple(arr.shape) != tuple(spec.shape):
                    raise ValueError(f"{name}.{path}: ckpt shape "
                                     f"{arr.shape} != spec "
                                     f"{tuple(spec.shape)}")
                where = (spec.device if isinstance(spec, torch.Tensor)
                         else device or torch.device("cpu"))
                return torch.from_numpy(np.array(arr)).to(where, spec.dtype)
            out[name] = map_with_paths(leaf, spec_tree)
        return out, manifest["extras"]
