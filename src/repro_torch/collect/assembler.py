"""Slab assembly: parsed wire samples → monitor ingest slabs.

The counterpart of :mod:`repro.collect.assembler`.
:class:`SlabAssembler` turns any stream of
:class:`~repro_torch.collect.wire.SampleBatch` chunks into flat
``(device, t, reading)`` slabs of exactly ``slab_samples`` samples
(the remainder on ``flush``), host arrays that the monitor moves to its
device as it ingests them.  Slab boundaries depend only on the sample
stream and the slab size, never on how the file reader chunked it.

:class:`CollectorPipeline` is the end-to-end loop the CLI wraps:
registry resolution (hot-add or reject), correction lookup against an
:class:`~repro_torch.core.calibrate_store.ArtifactStore`, a monitor built
lazily on ``device`` and widened by
:meth:`~repro_torch.core.stream.monitor.MonitorService.grow` when a new
gpu_uuid joins a lenient fleet.
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch._device import DeviceLike
from repro_torch.collect.registry import DeviceRegistry
from repro_torch.collect.wire import SampleBatch
from repro_torch.core.calibrate import CalibrationRecord
from repro_torch.core.calibrate_store import (ArtifactStore,
                                              resolve_corrections)
from repro_torch.core.stream.monitor import MonitorService

Slab = Tuple[np.ndarray, np.ndarray, np.ndarray]


class SlabAssembler:
    """Batch resolved samples into fixed-size ingest slabs (module doc).

    Usage::

        asm = SlabAssembler(registry, slab_samples=65536)
        for batch in wire.iter_batches(path):
            for dev, t, v in asm.push(batch):
                monitor.ingest(dev, t, v)
        for dev, t, v in asm.flush():
            monitor.ingest(dev, t, v)
    """

    def __init__(self, registry: DeviceRegistry, *,
                 slab_samples: int = 65536, rebase: bool = False):
        if slab_samples < 1:
            raise ValueError(f"slab_samples must be >= 1, "
                             f"got {slab_samples}")
        self.registry = registry
        self.slab_samples = int(slab_samples)
        self.rebase = bool(rebase)
        self.t0: Optional[float] = None     # rebase origin (first sample)
        self.n_samples = 0                  # samples pushed (pre-slab)
        self.n_slabs = 0
        self._dev: List[np.ndarray] = []
        self._t: List[np.ndarray] = []
        self._v: List[np.ndarray] = []
        self._buffered = 0

    def push(self, batch: SampleBatch) -> Iterator[Slab]:
        """Resolve one batch through the registry and yield every
        complete slab it fills.  Rejected uuids (frozen registry) keep
        their ``-1`` ids: the monitor's ``strict_ids=False`` path rejects
        and counts them."""
        k = len(batch)
        if k == 0:
            return
        dev = self.registry.resolve(batch.uuid, batch.t)
        t = np.asarray(batch.t, dtype=np.float64)
        if self.rebase:
            if self.t0 is None:
                self.t0 = float(t[0])
            t = t - self.t0
        self._dev.append(dev)
        self._t.append(t)
        self._v.append(np.asarray(batch.power_w, dtype=np.float64))
        self._buffered += k
        self.n_samples += k
        while self._buffered >= self.slab_samples:
            yield self._emit(self.slab_samples)

    def flush(self) -> Iterator[Slab]:
        """Yield the final partial slab (if any)."""
        if self._buffered:
            yield self._emit(self._buffered)

    def _emit(self, k: int) -> Slab:
        dev = np.concatenate(self._dev)
        t = np.concatenate(self._t)
        v = np.concatenate(self._v)
        self._dev, self._t, self._v = [dev[k:]], [t[k:]], [v[k:]]
        self._buffered = dev.size - k
        self.n_slabs += 1
        return dev[:k], t[:k], v[:k]


class CollectorPipeline:
    """Wire batches → calibrated streaming monitor on ``device`` (see
    module doc).

    ``store`` supplies per-device active calibration records (None →
    every device falls back to ``default_record`` or identity);
    ``max_age_s``/``now`` gate record freshness at resolve time (one
    ``now`` for the whole run).  The monitor is built lazily at the
    registry's width when the first slab lands, on ``device`` (the card
    by default), with ``strict_ids=False`` unless ``monitor_kwargs`` says
    otherwise, and grows on hot-add.
    """

    def __init__(self, *, store: Optional[ArtifactStore] = None,
                 default_record: Optional[CalibrationRecord] = None,
                 registry: Optional[DeviceRegistry] = None,
                 device: DeviceLike = "cuda",
                 slab_samples: int = 65536,
                 rebase: bool = False,
                 baseline_w: float = 0.0,
                 max_age_s: Optional[float] = None,
                 now: Optional[float] = None,
                 monitor_kwargs: Optional[dict] = None):
        self.store = store
        self.default_record = default_record
        self.registry = registry if registry is not None else DeviceRegistry()
        self.assembler = SlabAssembler(self.registry,
                                       slab_samples=slab_samples,
                                       rebase=rebase)
        self.device = device
        self.baseline_w = float(baseline_w)
        self.max_age_s = max_age_s
        self.now = float(now) if now is not None else time.time()
        self.monitor_kwargs = dict(monitor_kwargs or {})
        self.monitor_kwargs.setdefault("strict_ids", False)
        self.monitor_kwargs.setdefault("device", device)
        self.monitor: Optional[MonitorService] = None
        self.n_active_records = 0

    # -- correction resolution --------------------------------------------
    def _resolve(self, uuids) -> tuple:
        return resolve_corrections(
            uuids, store=self.store, default=self.default_record,
            baseline_w=self.baseline_w, max_age_s=self.max_age_s,
            now=self.now, device=self.monitor_kwargs["device"])

    # -- monitor lifecycle -------------------------------------------------
    def _ensure_monitor(self) -> MonitorService:
        n = max(self.registry.n_devices, 1)
        if self.monitor is None:
            corr, labels, n_act = self._resolve(self.registry.uuids)
            if self.registry.n_devices == 0:     # all-rejected stream:
                corr, labels = None, None        # a 1-wide husk monitor
            self.n_active_records = n_act
            self.monitor = MonitorService(
                n, corrections=corr, labels=labels, **self.monitor_kwargs)
        elif n > self.monitor.n_devices:
            n_old = self.monitor.n_devices
            tail = self.registry.uuids[n_old:]
            corr, labels, n_act = self._resolve(tail)
            self.n_active_records += n_act
            self.monitor.grow(n, corrections=corr, labels=labels)
        return self.monitor

    # -- driving -----------------------------------------------------------
    def feed(self, batch: SampleBatch) -> None:
        """Push one wire batch through registry + assembler, ingesting
        every complete slab (growing the monitor first when the batch
        hot-added devices)."""
        for dev, t, v in self.assembler.push(batch):
            self._ensure_monitor().ingest(dev, t, v)

    def finish(self) -> Optional[MonitorService]:
        """Flush the assembler's tail; returns the monitor (None when
        no sample ever arrived)."""
        for dev, t, v in self.assembler.flush():
            self._ensure_monitor().ingest(dev, t, v)
        return self.monitor

    def summary(self) -> dict:
        out = {
            "n_devices": self.registry.n_devices,
            "n_samples": self.assembler.n_samples,
            "n_slabs": self.assembler.n_slabs,
            "n_active_records": self.n_active_records,
            "registry_rejected": self.registry.n_rejected,
        }
        if self.monitor is not None:
            out["ingest"] = dict(self.monitor.counters)
        return out
