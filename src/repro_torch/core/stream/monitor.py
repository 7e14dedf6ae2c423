"""The streaming fleet monitor façade: ingest core + snapshot serving.

The counterpart of :mod:`repro.core.stream.monitor`.
:class:`MonitorService` delegates ingestion to
:class:`~.ingest.IngestCore` and every query to the current epoch's
:class:`~.snapshot.MonitorSnapshot`, published lazily at most once per
epoch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch._device import DeviceLike
from repro_torch.core.stream.estimators import StreamCorrections
from repro_torch.core.stream.ingest import IngestCore, IngestReport
from repro_torch.core.stream.snapshot import FleetEnergy, MonitorSnapshot

__all__ = ["FleetEnergy", "IngestReport", "MonitorService"]


class MonitorService:
    """Online fleet monitor over raw poll-sample slabs, state on the card.

    Usage::

        mon = MonitorService(n_devices, corrections=corr, labels=labels)
        mon.set_windows(a, b)              # optional §5 execution windows
        for dev, ts, vals in bank.iter_poll_slabs(0.0, 10.0, grid=True):
            mon.ingest_grid(dev, ts, vals)
        fleet = mon.fleet_energy(t=8.0)    # mid-run corrected energy

    Arguments: ``corrections`` (:class:`StreamCorrections`, identity by
    default), ``labels`` [N] workload labels, ``integration``
    (``"rectangle"`` or ``"trapezoid"``), ``max_hold_s`` (cap on how long
    one reading is extrapolated across a gap), ``envelope_w`` (the
    plausible ``(lo, hi)`` corrected-reading range), ``ring_slots``
    (recent samples kept per device for past queries), ``period_bins`` /
    ``min_runs`` (the online period estimator), ``silent_after_s`` and
    ``drift_*`` (the flags), ``strict_ids`` (raise on out-of-range ids
    rather than reject and count them) and ``device`` (``"cuda"`` by
    default; ``"cpu"`` runs the plain PyTorch path).  ``health=`` is not
    ported yet and raises.
    """

    def __init__(self, n_devices: int, *,
                 corrections: Optional[StreamCorrections] = None,
                 labels=None, integration: str = "rectangle",
                 max_hold_s=None, envelope_w: Optional[tuple] = None,
                 ring_slots: int = 8, period_bins: int = 24,
                 min_runs: int = 3, silent_after_s: Optional[float] = None,
                 drift_tau_s: float = 30.0, drift_rel: float = 0.25,
                 drift_abs_w: float = 5.0, strict_ids: bool = True,
                 health=None, device: DeviceLike = "cuda"):
        self._core = IngestCore(
            n_devices, corrections=corrections, labels=labels,
            integration=integration, max_hold_s=max_hold_s,
            envelope_w=envelope_w, ring_slots=ring_slots,
            period_bins=period_bins, min_runs=min_runs,
            silent_after_s=silent_after_s, drift_tau_s=drift_tau_s,
            drift_rel=drift_rel, drift_abs_w=drift_abs_w,
            strict_ids=strict_ids, health=health, device=device)
        self._snap: Optional[MonitorSnapshot] = None

    # -- layer access ------------------------------------------------------
    @property
    def core(self) -> IngestCore:
        """The mutable ingest core (write side)."""
        return self._core

    def snapshot(self) -> MonitorSnapshot:
        """The current epoch's published view, created lazily and reused
        until the next slab lands."""
        if self._snap is None or self._snap.epoch != self._core.epoch:
            self._snap = MonitorSnapshot.publish(self._core)
        return self._snap

    @property
    def epoch(self) -> int:
        return self._core.epoch

    @property
    def n_devices(self) -> int:
        return self._core.n_devices

    @property
    def device(self) -> torch.device:
        return self._core.device

    @property
    def corrections(self) -> StreamCorrections:
        return self._core.corrections

    @property
    def state(self):
        """Live (mutable) per-device accumulators; readers wanting a
        stable view use :meth:`snapshot`."""
        return self._core.state

    @property
    def ring(self):
        return self._core.ring

    @property
    def counters(self) -> Dict[str, int]:
        return self._core.counters

    def nbytes(self) -> int:
        return self._core.nbytes()

    # -- configuration and ingestion ---------------------------------------
    def set_windows(self, a, b) -> None:
        self._core.set_windows(a, b)

    set_windows.__doc__ = IngestCore.set_windows.__doc__

    def ingest(self, dev, t, v) -> IngestReport:
        return self._core.ingest(dev, t, v)

    ingest.__doc__ = IngestCore.ingest.__doc__

    def ingest_grid(self, dev, ts, vals) -> IngestReport:
        return self._core.ingest_grid(dev, ts, vals)

    ingest_grid.__doc__ = IngestCore.ingest_grid.__doc__

    # -- queries (delegated to the current snapshot) -----------------------
    def fleet_energy(self, t: Optional[float] = None,
                     corrected: bool = True) -> FleetEnergy:
        return self.snapshot().fleet_energy(t, corrected)

    fleet_energy.__doc__ = MonitorSnapshot.fleet_energy.__doc__

    def window_energy(self, t: Optional[float] = None,
                      corrected: bool = True) -> torch.Tensor:
        return self.snapshot().window_energy(t, corrected)

    window_energy.__doc__ = MonitorSnapshot.window_energy.__doc__

    def energy_between(self, t0: float, t1: float, corrected: bool = True):
        return self.snapshot().energy_between(t0, t1, corrected)

    energy_between.__doc__ = MonitorSnapshot.energy_between.__doc__

    def by_label(self, t0: Optional[float] = None,
                 t1: Optional[float] = None, corrected: bool = True):
        return self.snapshot().by_label(t0, t1, corrected)

    by_label.__doc__ = MonitorSnapshot.by_label.__doc__

    def reading_stats(self):
        return self.snapshot().reading_stats()

    reading_stats.__doc__ = MonitorSnapshot.reading_stats.__doc__

    def update_period_s(self) -> torch.Tensor:
        return self.snapshot().update_period_s()

    update_period_s.__doc__ = MonitorSnapshot.update_period_s.__doc__

    def flags(self, t: Optional[float] = None):
        return self.snapshot().flags(t)

    flags.__doc__ = MonitorSnapshot.flags.__doc__
