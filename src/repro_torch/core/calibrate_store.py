"""Versioned, persisted calibration artifacts with active-record tracking.

The counterpart of :mod:`repro.core.calibrate_store`, writing and reading
the same files byte for byte, so either package reads a store the other
wrote.  The :class:`~repro_torch.core.calibrate.CalibrationStore` in
``calibrate.py``
is the job-launcher cache: one mutable JSON file per device, overwritten
on re-characterisation.  A deployed fleet auditor needs the estimator
lifecycle instead (the Pioreactor estimator-store pattern): every fitted
:class:`~repro_torch.core.calibrate.CalibrationRecord` is an **immutable,
versioned artifact** saved to disk, at most one version per device is
**active** at a time, and stale artifacts are **aged out** by a
``max_age_s`` policy instead of silently trusted forever.

Layout (all plain JSON, human-diffable)::

    <root>/
      devices/<device_id>/v0001.json      # artifact, never rewritten
      devices/<device_id>/v0002.json
      active.json                         # {device_id: version} tracking

``active.json`` is rewritten atomically (tmp + rename) so a crashed
writer can never leave a torn activation map.  Device ids are
sanitised for the filesystem exactly like the legacy store
(``/`` → ``_``).

:meth:`ArtifactStore.resolve` turns the active records for a list of
device ids into the stacked
:class:`~repro_torch.core.stream.estimators.StreamCorrections` (tensors
on the caller's device) the streaming monitor consumes — the bridge
between the artifact lifecycle and the ingest hot path.  Devices without an active (or fresh-enough) record
fall back to a caller-supplied default record, or to identity
corrections (gain 1, no offset, no time shift) when there is none:
never a stale guess.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from repro_torch._device import DeviceLike
from repro_torch.core.calibrate import CalibrationRecord

log = logging.getLogger(__name__)

_VERSION_RE = re.compile(r"^v(\d{4,})\.json$")


class StoreError(RuntimeError):
    """A calibration-store operation could not be honoured (unknown
    device/version, activating a missing artifact, corrupt layout)."""


def _safe(device_id: str) -> str:
    return device_id.replace("/", "_")


def record_stamp(rec: CalibrationRecord) -> float:
    """The age-out reference instant of a record: ``fitted_at`` when the
    characterisation stamped one, else ``created_at``.  Returns 0.0 for
    legacy/synthetic records with no provenance at all — callers treat
    an unknown age as *never expiring* (ageing out a record because it
    predates the ``fitted_at`` field would silently un-calibrate every
    legacy fleet)."""
    if rec.fitted_at is not None:
        return float(rec.fitted_at)
    return float(rec.created_at or 0.0)


@dataclasses.dataclass(frozen=True)
class ArtifactInfo:
    """One saved artifact as listed by :meth:`ArtifactStore.versions`."""

    device_id: str
    version: int
    path: str
    active: bool
    record: CalibrationRecord

    @property
    def stamp(self) -> float:
        return record_stamp(self.record)

    def summary(self) -> dict:
        rec = self.record
        return {
            "device_id": self.device_id,
            "version": self.version,
            "active": self.active,
            "profile": rec.profile_name,
            "gain": rec.gain,
            "offset_w": rec.offset_w,
            "update_period_s": rec.update_period_s,
            "fitted_at": rec.fitted_at,
            "source": rec.source,
        }


class ArtifactStore:
    """Versioned on-disk calibration artifacts (see module doc).

    Usage::

        store = ArtifactStore(root)
        v = store.save(record, activate=True)      # -> 1, 2, 3, ...
        rec = store.active(record.device_id)       # the activated record
        store.activate(dev, v - 1)                 # roll back one version
        store.gc(max_age_s=90 * 86400)             # age out stale artifacts
        corr = store.resolve(uuids)                # -> StreamCorrections
    """

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(os.path.join(self.root, "devices"), exist_ok=True)

    # -- layout ------------------------------------------------------------
    def _device_dir(self, device_id: str) -> str:
        return os.path.join(self.root, "devices", _safe(device_id))

    def _artifact_path(self, device_id: str, version: int) -> str:
        return os.path.join(self._device_dir(device_id),
                            f"v{int(version):04d}.json")

    def _active_path(self) -> str:
        return os.path.join(self.root, "active.json")

    def _active_map(self) -> Dict[str, int]:
        p = self._active_path()
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise StoreError(f"corrupt active map {p}: expected an "
                             f"object, got {type(data).__name__}")
        return {str(k): int(v) for k, v in data.items()}

    def _write_active_map(self, m: Dict[str, int]) -> None:
        p = self._active_path()
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(sorted(m.items())), f, indent=2)
        os.replace(tmp, p)

    # -- artifact lifecycle ------------------------------------------------
    def devices(self) -> List[str]:
        """Sanitised device ids with at least one saved artifact."""
        d = os.path.join(self.root, "devices")
        return sorted(x for x in os.listdir(d)
                      if os.path.isdir(os.path.join(d, x)))

    def _version_numbers(self, device_id: str) -> List[int]:
        d = self._device_dir(device_id)
        if not os.path.isdir(d):
            return []
        out = []
        for name in os.listdir(d):
            m = _VERSION_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, rec: CalibrationRecord, activate: bool = False) -> int:
        """Persist ``rec`` as the next version for its device (versions
        are append-only — an artifact file is never rewritten).  Returns
        the version number; with ``activate=True`` the new artifact
        also becomes the device's active record."""
        versions = self._version_numbers(rec.device_id)
        v = (versions[-1] + 1) if versions else 1
        os.makedirs(self._device_dir(rec.device_id), exist_ok=True)
        path = self._artifact_path(rec.device_id, v)
        with open(path, "w") as f:
            f.write(rec.to_json())
        log.info("saved calibration artifact %s v%d", rec.device_id, v)
        if activate:
            self.activate(rec.device_id, v)
        return v

    def load(self, device_id: str, version: int) -> CalibrationRecord:
        path = self._artifact_path(device_id, version)
        if not os.path.exists(path):
            raise StoreError(f"no artifact v{version} for device "
                             f"'{device_id}' under {self.root}")
        with open(path) as f:
            return CalibrationRecord.from_json(f.read())

    def versions(self, device_id: str) -> List[ArtifactInfo]:
        """Every saved artifact for a device, oldest first."""
        act = self._active_map().get(_safe(device_id))
        return [ArtifactInfo(device_id=device_id, version=v,
                             path=self._artifact_path(device_id, v),
                             active=(v == act),
                             record=self.load(device_id, v))
                for v in self._version_numbers(device_id)]

    def list_all(self) -> List[ArtifactInfo]:
        return [info for dev in self.devices()
                for info in self.versions(dev)]

    def activate(self, device_id: str, version: int) -> None:
        """Mark ``version`` as the device's active record (it must
        exist — activating a phantom artifact is a :class:`StoreError`,
        not a deferred surprise)."""
        if not os.path.exists(self._artifact_path(device_id, version)):
            raise StoreError(f"cannot activate v{version} for "
                             f"'{device_id}': artifact does not exist")
        m = self._active_map()
        m[_safe(device_id)] = int(version)
        self._write_active_map(m)

    def deactivate(self, device_id: str) -> bool:
        """Clear the device's active record (the device falls back to
        the resolver's default).  Returns whether one was active."""
        m = self._active_map()
        was = m.pop(_safe(device_id), None)
        if was is not None:
            self._write_active_map(m)
        return was is not None

    def active_version(self, device_id: str) -> Optional[int]:
        return self._active_map().get(_safe(device_id))

    def active(self, device_id: str,
               max_age_s: Optional[float] = None,
               now: Optional[float] = None) -> Optional[CalibrationRecord]:
        """The device's active record, or None when none is active — or
        when the active record is older than ``max_age_s`` (a stale
        characterisation is worse than an honest "uncalibrated":
        sensors drift, software updates change the averaging window).
        Records without any provenance stamp never age out (see
        :func:`record_stamp`)."""
        v = self.active_version(device_id)
        if v is None:
            return None
        rec = self.load(device_id, v)
        if max_age_s is not None:
            stamp = record_stamp(rec)
            t = time.time() if now is None else float(now)
            if stamp > 0.0 and (t - stamp) > float(max_age_s):
                return None
        return rec

    def gc(self, max_age_s: float, now: Optional[float] = None,
           keep_active: bool = True, dry_run: bool = False) -> List[str]:
        """Delete artifacts older than ``max_age_s``; returns the
        removed paths.  Active artifacts are kept by default (delete the
        activation first if you really mean it); records without a
        provenance stamp are never collected."""
        t = time.time() if now is None else float(now)
        removed = []
        act = self._active_map()
        for dev in self.devices():
            for v in self._version_numbers(dev):
                rec = self.load(dev, v)
                stamp = record_stamp(rec)
                if stamp <= 0.0 or (t - stamp) <= float(max_age_s):
                    continue
                if keep_active and act.get(dev) == v:
                    continue
                path = self._artifact_path(dev, v)
                removed.append(path)
                if not dry_run:
                    os.remove(path)
        if removed and not dry_run:
            log.info("aged out %d calibration artifacts", len(removed))
        return removed

    # -- the bridge into the streaming monitor -----------------------------
    def resolve(self, device_ids: Sequence[str],
                default: Optional[CalibrationRecord] = None,
                baseline_w: float | np.ndarray = 0.0,
                max_age_s: Optional[float] = None,
                now: Optional[float] = None, *,
                device: DeviceLike = "cuda"):
        """Stack the active records for ``device_ids`` into the
        :class:`~repro_torch.core.stream.estimators.StreamCorrections` the
        monitor's ingest kernels consume, on ``device``.  See
        :func:`resolve_corrections` for the per-device fallback rules.
        """
        return resolve_corrections(device_ids, store=self, default=default,
                                   baseline_w=baseline_w,
                                   max_age_s=max_age_s, now=now,
                                   device=device)


def resolve_corrections(device_ids: Sequence[str],
                        store: Optional[ArtifactStore] = None,
                        default: Optional[CalibrationRecord] = None,
                        baseline_w: float | np.ndarray = 0.0,
                        max_age_s: Optional[float] = None,
                        now: Optional[float] = None, *,
                        device: DeviceLike = "cuda"):
    """Per-device corrections + labels from a store's active records.

    For each device id, in order: the store's active (and fresh-enough,
    under ``max_age_s``) record; else ``default``; else identity
    corrections (gain 1, offset 0, no time shift, 0.1 s reference
    period, ``calibrated=False``) — an unknown device is treated as an
    honest uncalibrated sensor, never given another device's gains.

    Returns ``(StreamCorrections, labels, n_active)`` where ``labels``
    [N] carries each record's profile name (``"uncalibrated"`` for the
    identity fallback) — ready for ``MonitorService(labels=)`` so
    by-label breakdowns group by sensor class.  The corrections are built
    on the host and moved to ``device``.
    """
    from repro_torch.core.stream.estimators import StreamCorrections

    ids = list(device_ids)
    n = len(ids)
    gain = np.ones(n)
    offset = np.zeros(n)
    shift = np.zeros(n)
    ref = np.full(n, 0.1)
    calib = np.zeros(n, dtype=bool)
    labels = np.full(n, "uncalibrated", dtype=object)
    n_active = 0
    for i, dev in enumerate(ids):
        rec = (store.active(dev, max_age_s=max_age_s, now=now)
               if store is not None else None)
        if rec is not None:
            n_active += 1
        elif default is not None:
            rec = default
        else:
            continue
        gain[i] = rec.correction_gain
        offset[i] = rec.correction_offset_w
        shift[i] = rec.time_shift_s
        ref[i] = rec.update_period_s
        calib[i] = rec.gain is not None
        labels[i] = rec.profile_name
    base = np.broadcast_to(np.asarray(baseline_w, dtype=np.float64),
                           (n,)).copy()
    corr = StreamCorrections(**{
        k: torch.as_tensor(v) for k, v in (
            ("gain", gain), ("offset_w", offset), ("time_shift_s", shift),
            ("baseline_w", base), ("ref_period_s", ref),
            ("calibrated", calib))}).to(device)
    return corr, labels, n_active
