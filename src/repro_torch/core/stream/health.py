"""Per-device health state machine: healthy → stale → quarantined.

The counterpart of :mod:`repro.core.stream.health`, with the machine's
state on the card.  The monitor's flags (:meth:`MonitorSnapshot.flags`)
are instantaneous observations — silent, anomalous, drifting.  The
machine adds memory on top of the same signals, evaluated at slab
boundaries: each device walks three states, and quarantined devices are
left out of fleet aggregates until they stream cleanly again for
:attr:`HealthPolicy.recover_after_s`.

* ``HEALTHY`` (0) — reporting on schedule, inside the envelope, no drift;
* ``STALE`` (1) — no sample for longer than ``stale_factor ×`` the
  per-device silent threshold (the one ``flags`` uses: the online
  update-period estimate when converged, else the calibration's, × 5; or
  the monitor's explicit ``silent_after_s``).  Stale devices still count
  in aggregates;
* ``QUARANTINED`` (2) — silent past ``quarantine_factor ×`` the
  threshold, or fresh out-of-envelope readings (``quarantine_anomalous``),
  or drifting readings (``quarantine_drifting``).

Health tracking is opt-in (``MonitorService(health=HealthPolicy())``):
without a policy the monitor does no health work at all.  One step is
about twenty elementwise operations over [N] tensors, plain PyTorch on
the monitor's device, as the reference computes it in plain numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.stream import schema

HEALTHY = 0
STALE = 1
QUARANTINED = 2

STATE_NAMES = {HEALTHY: "healthy", STALE: "stale",
               QUARANTINED: "quarantined"}

F64, I64 = torch.float64, torch.int64


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """When devices demote and promote through the health machine.

    Thresholds are multiples of the monitor's per-device silent threshold
    (see the module doc), so one policy adapts to heterogeneous update
    periods.  ``recover_after_s`` is the clean streak a quarantined device
    must sustain before re-admission (0 readmits on the first clean
    evaluation)."""

    stale_factor: float = 1.0
    quarantine_factor: float = 3.0
    quarantine_anomalous: bool = True
    quarantine_drifting: bool = True
    recover_after_s: float = 0.0

    def __post_init__(self):
        if not 0.0 < self.stale_factor <= self.quarantine_factor:
            raise ValueError(
                f"need 0 < stale_factor <= quarantine_factor, got "
                f"{self.stale_factor} / {self.quarantine_factor}")
        if self.recover_after_s < 0.0:
            raise ValueError("recover_after_s must be >= 0")

    def to_meta(self) -> dict:
        """JSON-able form for checkpoint manifests."""
        return dataclasses.asdict(self)

    @classmethod
    def from_meta(cls, d: dict) -> "HealthPolicy":
        return cls(**d)


class HealthTracker:
    """The machine's [N] tensors; the field set is
    ``schema.HEALTH_FIELDS``."""

    def __init__(self, code, since_t, clean_t, clean, last_n_out,
                 n_quarantines):
        self.code = code                    # [N] int8 state code
        self.since_t = since_t              # [N] f64 last transition time
        self.clean_t = clean_t              # [N] f64 clean-streak start
        self.clean = clean                  # [N] bool in a clean streak
        self.last_n_out = last_n_out        # [N] int64 n_out at last step
        self.n_quarantines = n_quarantines  # [N] int64 lifetime count

    @classmethod
    def zeros(cls, n: int, device) -> "HealthTracker":
        return cls(code=torch.zeros(n, dtype=torch.int8, device=device),
                   since_t=torch.zeros(n, dtype=F64, device=device),
                   clean_t=torch.zeros(n, dtype=F64, device=device),
                   clean=torch.zeros(n, dtype=torch.bool, device=device),
                   last_n_out=torch.zeros(n, dtype=I64, device=device),
                   n_quarantines=torch.zeros(n, dtype=I64, device=device))

    def nbytes(self) -> int:
        return schema.registry_nbytes(self, schema.HEALTH_FIELDS,
                                      "HealthTracker")

    def count_tensors(self):
        """``(n_healthy, n_stale, n_quarantined)`` as 0-d tensors, for a
        caller that reads them back with others in one transfer."""
        return ((self.code == HEALTHY).sum(), (self.code == STALE).sum(),
                (self.code == QUARANTINED).sum())

    def counts(self) -> Dict[str, int]:
        vals = torch.stack(self.count_tensors()).tolist()
        return dict(zip(("n_healthy", "n_stale", "n_quarantined"), vals))

    def update(self, st, *, t_now: float, policy: HealthPolicy,
               period_est: torch.Tensor, ref_period_s: torch.Tensor,
               silent_after_s: Optional[float], drift_tau_s: float,
               drift_rel: float, drift_abs_w: float) -> torch.Tensor:
        """One health step at wall-clock ``t_now`` against the
        :class:`~.state.DeviceState` accumulators ``st``.  Returns a 0-d
        bool tensor on the device, True when any device changed state;
        nothing here waits for the device.

        The silence, anomaly and drift criteria are the rules
        :meth:`MonitorSnapshot.flags` reports; the masked assignments run
        in the reference's order (stale, quarantined, then promotions)."""
        t_now = float(t_now)
        ref = torch.where(torch.isfinite(period_est), period_est,
                          ref_period_s)
        after = (torch.full_like(ref, float(silent_after_s))
                 if silent_after_s is not None else 5.0 * ref)
        silent_for = t_now - st.last_t
        stale_sig = st.has & (silent_for > policy.stale_factor * after)
        dead_sig = st.has & (silent_for > policy.quarantine_factor * after)
        fresh_anom = st.has & (st.n_out > self.last_n_out)
        dur = st.last_t - st.first_t
        # dur == 0 divides by zero in the branch torch.where discards
        mean_p = torch.where(dur > 0.0, st.energy_corr_j / dur,
                             float("nan"))
        dev_w = (st.ewma_w - mean_p).abs()
        drift_sig = (st.has & (dur > 2.0 * drift_tau_s)
                     & (dev_w > torch.clamp_min(drift_rel * mean_p.abs(),
                                                drift_abs_w)))
        drift_sig = drift_sig & torch.isfinite(mean_p)

        bad = dead_sig
        if policy.quarantine_anomalous:
            bad = bad | fresh_anom
        if policy.quarantine_drifting:
            bad = bad | drift_sig
        clean_now = st.has & ~stale_sig & ~fresh_anom & ~drift_sig
        starting = clean_now & ~self.clean
        self.clean_t = torch.where(starting, t_now, self.clean_t)

        code = self.code
        new = code.masked_fill((code == HEALTHY) & stale_sig & ~bad, STALE)
        new = new.masked_fill(bad, QUARANTINED)
        promote_stale = (code == STALE) & clean_now & ~bad
        dwell_ok = (t_now - self.clean_t) >= policy.recover_after_s
        promote_q = (code == QUARANTINED) & clean_now & dwell_ok & ~bad
        new = new.masked_fill(promote_stale | promote_q, HEALTHY)

        changed = new != code
        self.n_quarantines = self.n_quarantines + (
            (new == QUARANTINED) & (code != QUARANTINED))
        self.since_t = torch.where(changed, t_now, self.since_t)
        self.code = new
        self.clean = clean_now
        self.last_n_out = st.n_out.clone()
        return changed.any()
