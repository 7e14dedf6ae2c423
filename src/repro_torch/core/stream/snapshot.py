"""Immutable, epoch-tagged published views of the streaming monitor.

The counterpart of :mod:`repro.core.stream.snapshot`.
:class:`MonitorSnapshot.publish` clones everything queries need — the
:class:`~.state.DeviceState` tensors, the ring pre-sorted per device, the
period estimates — on the card, at a slab boundary.  Tensors have no
read-only flag, so immutability is by construction: nothing holds a
reference to the clones but the snapshot, and ingestion after
``publish`` leaves a held snapshot's answers unchanged.

Query edge contract (as the reference's): ``energy_between(t0, t1)``
raises unless ``t0 <= t1``; instants beyond the ring horizon answer nan
with ``covered=False``; ``by_label`` groups with no covered device report
nan ``mean_j``/``std_j``.  Per-device results are tensors on the
monitor's device; totals and moments are Python floats.

On a health-tracked monitor the snapshot also freezes the health codes:
quarantined devices are left out of ``fleet_energy`` and ``by_label``
aggregates (degraded mode, see :class:`FleetEnergy`), and ``flags``
reports the machine's ``stale``/``quarantined`` states.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import math

import torch

from repro_torch.core.fleet_engine import StreamingMoments
from repro_torch.core.stream.health import QUARANTINED, STALE
from repro_torch.core.telemetry import CALIBRATED_TOLERANCE, SHUNT_TOLERANCE
from repro_torch.engine_backend import torch_backend as _tb

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class FleetEnergy:
    """A fleet-energy answer with uncertainty bounds.  ``per_device_j`` is
    nan where ``covered`` is False; totals and sigmas are over covered
    devices (independent 1/√N and worst-case correlated bounds).

    Degraded mode (health-tracked monitors): quarantined devices are left
    out of ``total_j`` and the sigmas (their ``per_device_j`` rows stay),
    the sigmas widen by ``n_covered / n_included``, and ``coverage`` is
    the included fraction of the fleet; ``inf`` sigmas when every covered
    device is quarantined.  Without health tracking ``coverage`` is the
    covered fraction and ``n_quarantined`` 0."""

    t: Optional[float]
    corrected: bool
    per_device_j: torch.Tensor
    covered: torch.Tensor
    total_j: float
    n_reporting: int
    sigma_independent_j: float
    sigma_worstcase_j: float
    coverage: float = 1.0
    n_quarantined: int = 0


def _copy_moments(sm: StreamingMoments) -> StreamingMoments:
    out = StreamingMoments()
    out.n, out.mean, out.m2 = sm.n, sm.mean, sm.m2
    out.mean_abs, out.max_abs = sm.mean_abs, sm.max_abs
    return out


class MonitorSnapshot:
    """One immutable published view of a monitor; build with
    :meth:`publish`."""

    def __init__(self, *, epoch, n_devices, state, ring_view, ring_slots,
                 period_est, moments, counters, corrections,
                 label_names, label_codes, win_a, win_b, max_hold,
                 silent_after_s,
                 drift_tau_s, drift_rel, drift_abs_w, health_code=None):
        self.epoch = epoch
        self.n_devices = n_devices
        self.state = state
        self._ring_view = ring_view          # (t, v, e_raw, e_corr) or None
        self.ring_slots = ring_slots
        self._period_est = period_est
        self._moments = moments
        self._counters = counters
        self.corrections = corrections
        self._label_names = label_names
        self._label_codes = label_codes
        self._win_a = win_a
        self._win_b = win_b
        self._max_hold = max_hold
        self.silent_after_s = silent_after_s
        self.drift_tau_s = drift_tau_s
        self.drift_rel = drift_rel
        self.drift_abs_w = drift_abs_w
        self._health_code = health_code      # [N] int8 codes or None
        self._flavor_cache: Dict[bool, tuple] = {}

    @classmethod
    def publish(cls, core) -> "MonitorSnapshot":
        """Clone an :class:`~.ingest.IngestCore`'s state at its current
        epoch, on its device; the ring is captured already sorted."""
        # sorted_view gathers into fresh tensors: already a copy
        ring_view = core.ring.sorted_view() if core.ring.slots else None
        return cls(
            epoch=core.epoch, n_devices=core.n_devices,
            state=core.state.clone(), ring_view=ring_view,
            ring_slots=core.ring.slots,
            period_est=core.periods.estimates(),
            moments={k: _copy_moments(v) for k, v in core._moments.items()},
            counters=dict(core.counters),
            corrections=core.corrections,
            label_names=list(core._label_names),
            label_codes=core._label_codes.clone(),
            win_a=core._win_a.clone(), win_b=core._win_b.clone(),
            max_hold=core._max_hold.clone(),
            silent_after_s=core.silent_after_s,
            drift_tau_s=core.drift_tau_s, drift_rel=core.drift_rel,
            drift_abs_w=core.drift_abs_w,
            health_code=(core.health.code.clone()
                         if core.health is not None else None))

    @property
    def device(self) -> torch.device:
        return self.state.last_t.device

    # -- batched ops ------------------------------------------------------
    def _flavor(self, corrected: bool):
        """Per-flavour (raw/corrected) tail + ring tensors, computed once
        per snapshot."""
        if corrected not in self._flavor_cache:
            st, c = self.state, self.corrections
            if corrected:
                dens = (st.last_v - c.offset_w) / c.gain
                base = st.energy_corr_j
            else:
                dens, base = st.last_v, st.energy_j
            if self._ring_view is not None:
                ts, vs, er, ec = self._ring_view
                if corrected:
                    ring_dens = ((vs - c.offset_w[:, None])
                                 / c.gain[:, None])
                    ring_base = ec
                else:
                    ring_dens, ring_base = vs, er
            else:
                ts = ring_dens = ring_base = None
            self._flavor_cache[corrected] = (dens, base, ts, ring_dens,
                                             ring_base)
        return self._flavor_cache[corrected]

    def _instants(self, tq) -> torch.Tensor:
        return torch.as_tensor(tq, dtype=F64, device=self.device).reshape(-1)

    def energy_at_batch(self, tq, corrected: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Energy since first sample at instants ``tq`` [Q] for every
        device: ``(e, covered)`` [Q, N], nan before ring coverage."""
        st = self.state
        dens, base, ring_t, ring_dens, ring_base = self._flavor(corrected)
        return _tb.snapshot_energy_at(self._instants(tq), st.last_t, dens,
                                      st.has, st.first_t, base,
                                      self._max_hold, ring_t, ring_dens,
                                      ring_base)

    def window_energy_batch(self, tq, corrected: bool = True) -> torch.Tensor:
        """Registered-window energy at instants ``tq`` [Q] → [Q, N]."""
        tq = self._instants(tq)
        st, c = self.state, self.corrections
        e = (st.win_corr_j if corrected else st.win_j)[None, :]
        shift = c.time_shift_s if corrected else 0.0
        t_rep = st.last_t - shift       # newest sample, reported time
        tqs = tq[:, None] - shift       # query instants, reported time
        dens = ((st.last_v - c.offset_w) / c.gain if corrected
                else st.last_v)
        lim = torch.minimum(tqs, torch.minimum(
            self._win_b, t_rep + self._max_hold)[None, :])
        zero = torch.zeros((), dtype=F64, device=self.device)
        tail = torch.where(
            st.has[None, :] & (t_rep >= self._win_a)[None, :],
            dens[None, :] * torch.clamp_min(lim - t_rep[None, :], 0.0), zero)
        # an open window already streamed past tq is not reconstructible
        stale = (st.has[None, :] & (tqs < t_rep[None, :])
                 & (tqs < self._win_b[None, :])
                 & (tqs > self._win_a[None, :]))
        out = torch.where(stale, float("nan"), e + tail)
        # before the window opens the exact answer is 0
        return torch.where(st.has[None, :] & (tqs <= self._win_a[None, :]),
                           zero, out)

    # -- result assembly (shared with the batched executor) ---------------
    @property
    def active_mask(self) -> Optional[torch.Tensor]:
        """[N] bool, False where the health machine quarantined the device;
        None without health tracking."""
        if self._health_code is None:
            return None
        return self._health_code != QUARANTINED

    def fleet_from_rows(self, t: Optional[float], corrected: bool,
                        e: torch.Tensor, covered: torch.Tensor
                        ) -> FleetEnergy:
        """Fold one [N] energy row into a :class:`FleetEnergy` (the
        reduction of the direct and the batched paths), degraded mode
        included."""
        zero = torch.zeros((), dtype=F64, device=self.device)
        tol = torch.where(self.corrections.calibrated,
                          zero + CALIBRATED_TOLERANCE, zero + SHUNT_TOLERANCE)
        active = self.active_mask
        include = covered if active is None else covered & active
        sig = torch.where(include, tol * torch.nan_to_num(e).abs(), zero)
        total, s2, s1, n_inc, n_rep, n_q = torch.stack([
            torch.where(include, e, zero).nansum(), (sig ** 2).sum(),
            sig.sum(), include.sum().to(F64), self.state.has.sum().to(F64),
            (zero if active is None
             else (covered & ~active).sum().to(F64))]).tolist()
        n_inc, n_q = int(n_inc), int(n_q)
        if n_q == 0:
            si, sw = math.sqrt(s2), float(s1)
        elif n_inc:
            widen = (n_inc + n_q) / n_inc
            si, sw = widen * math.sqrt(s2), widen * s1
        else:           # every covered device quarantined: the answer
            si = sw = math.inf          # carries no information
        return FleetEnergy(
            t=t, corrected=corrected, per_device_j=e, covered=covered,
            total_j=float(total), n_reporting=int(n_rep),
            sigma_independent_j=float(si), sigma_worstcase_j=float(sw),
            coverage=n_inc / self.n_devices, n_quarantined=n_q)

    @staticmethod
    def between_from_rows(e0, c0, e1, c1) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        covered = c0 & c1
        return torch.where(covered, e1 - e0, float("nan")), covered

    def label_stats(self, e: torch.Tensor, covered: torch.Tensor
                    ) -> Dict[str, Dict[str, float]]:
        """Per-label count, total and moments of the covered devices'
        energies ``e`` [N] (the reduction behind :meth:`by_label` and the
        batched executor's); quarantined devices are left out and counted
        per label as ``n_quarantined``."""
        out: Dict[str, Dict[str, float]] = {}
        nl = len(self._label_names)
        active = self.active_mask
        counts = [torch.bincount(self._label_codes, minlength=nl)]
        if active is not None:
            counts.append(torch.bincount(
                self._label_codes[covered & ~active], minlength=nl))
            covered = covered & active
        counts = torch.stack(counts).tolist()
        sizes = counts[0]
        n_quar = counts[1] if active is not None else [0] * nl
        for ci, label in enumerate(self._label_names):
            vals = e[(self._label_codes == ci) & covered]
            sm = StreamingMoments().update(vals)
            stats = sm.stats()
            n_cov = int(sm.n)
            out[label] = {
                "n_devices": int(sizes[ci]),
                "n_covered": n_cov,
                "n_quarantined": int(n_quar[ci]),
                "total_j": float(vals.sum()) if n_cov else 0.0,
                "mean_j": stats["mean_err"] if n_cov else float("nan"),
                "std_j": stats["std_err"] if n_cov else float("nan"),
            }
        return out

    # -- queries ----------------------------------------------------------
    def fleet_energy(self, t: Optional[float] = None,
                     corrected: bool = True) -> FleetEnergy:
        """Running fleet energy at wall-clock ``t`` (default: each
        device's newest sample), with the telemetry uncertainty bounds."""
        st = self.state
        if t is None:
            e = (st.energy_corr_j if corrected else st.energy_j).clone()
            covered = torch.ones(self.n_devices, dtype=torch.bool,
                                 device=self.device)
        else:
            em, cm = self.energy_at_batch([float(t)], corrected)
            e, covered = em[0], cm[0]
        return self.fleet_from_rows(t, corrected, e, covered)

    def window_energy(self, t: Optional[float] = None,
                      corrected: bool = True) -> torch.Tensor:
        """Per-device energy clipped to the registered §5 windows [N]
        (nan where a still-open window already streamed past ``t``)."""
        st = self.state
        if t is None:
            return (st.win_corr_j if corrected else st.win_j).clone()
        return self.window_energy_batch([float(t)], corrected)[0]

    def energy_between(self, t0: float, t1: float, corrected: bool = True):
        """Windowed energy ∫[t0, t1] per device from the ring buffer:
        ``(energy, covered)``, exact within ring coverage, nan outside."""
        if not (t1 >= t0):
            raise ValueError(f"bad window [{t0}, {t1}]")
        em, cm = self.energy_at_batch([float(t0), float(t1)], corrected)
        return self.between_from_rows(em[0], cm[0], em[1], cm[1])

    def by_label(self, t0: Optional[float] = None,
                 t1: Optional[float] = None,
                 corrected: bool = True) -> Dict[str, Dict[str, float]]:
        """Energy breakdown by workload label, over ``[t0, t1]`` (ring
        coverage permitting) or since stream start."""
        if (t0 is None) != (t1 is None):
            raise ValueError("pass both t0 and t1, or neither")
        st = self.state
        if t0 is None:
            e = st.energy_corr_j if corrected else st.energy_j
            covered = st.has
        else:
            e, covered = self.energy_between(t0, t1, corrected)
            covered = covered & st.has
        return self.label_stats(e, covered)

    def reading_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-label corrected-reading moments accumulated at ingest."""
        return {label: sm.stats()
                for label, sm in sorted(self._moments.items())}

    def update_period_s(self) -> torch.Tensor:
        """[N] online update-period estimates (nan until converged)."""
        return self._period_est.clone()

    def flags(self, t: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """Per-device flags at wall-clock ``t`` (default: the newest
        sample fleet-wide): ``reporting``, ``silent``, ``anomalous``,
        ``drifting``, and the health machine's ``stale``/``quarantined``
        states (all-False without health tracking)."""
        st = self.state
        if t is None:
            t = (float(st.last_t[st.has].max()) if bool(st.has.any())
                 else 0.0)
        that = self._period_est
        ref = torch.where(torch.isfinite(that), that,
                          self.corrections.ref_period_s)
        after = (torch.full_like(ref, float(self.silent_after_s))
                 if self.silent_after_s is not None else 5.0 * ref)
        silent = st.has & (t - st.last_t > after)
        dur = st.last_t - st.first_t
        mean_p = torch.where(dur > 0.0, st.energy_corr_j / dur,
                             float("nan"))
        dev = (st.ewma_w - mean_p).abs()
        drifting = (st.has & (dur > 2.0 * self.drift_tau_s)
                    & (dev > torch.clamp_min(self.drift_rel * mean_p.abs(),
                                             self.drift_abs_w)))
        code = self._health_code
        none = torch.zeros_like(st.has)
        return {
            "reporting": st.has.clone(),
            "silent": silent,
            "anomalous": st.n_out > 0,
            "drifting": torch.where(torch.isfinite(mean_p), drifting, False),
            "stale": code == STALE if code is not None else none,
            "quarantined": (code == QUARANTINED if code is not None
                            else none.clone()),
        }

    def health_summary(self) -> Dict[str, float]:
        """Fleet-level health digest: the machine's population counts and
        the coverage degraded-mode queries report.  Without health
        tracking every device counts healthy and ``tracked`` is False."""
        n = self.n_devices
        code = self._health_code
        sums = [self.state.has.sum()]
        if code is not None:
            sums += [(code == STALE).sum(), (code == QUARANTINED).sum()]
        vals = [int(x) for x in torch.stack(sums).tolist()]
        n_stale, n_quar = vals[1:] if code is not None else (0, 0)
        return {
            "tracked": code is not None,
            "epoch": int(self.epoch),
            "n_devices": n,
            "n_reporting": vals[0],
            "n_healthy": n - n_stale - n_quar,
            "n_stale": n_stale,
            "n_quarantined": n_quar,
            "coverage": (n - n_quar) / n,
        }

    @property
    def counters(self) -> Dict[str, int]:
        return dict(self._counters)
