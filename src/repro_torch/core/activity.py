"""Roofline-driven activity model: an executed step → a power timeline (a
port of :mod:`repro.core.activity`).

Each executed step contributes an :class:`ActivityTimeline` fragment
whose power level follows the step's compute/memory utilisation: the
"SM-fraction → power amplitude" relationship of the paper.  The
timelines are host-side float64, built by
:func:`repro_torch.core.ground_truth.from_segments`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.ground_truth import ActivityTimeline, from_segments


@dataclasses.dataclass(frozen=True)
class ChipPowerModel:
    """Per-chip power envelope (a documented assumption, not a reading)."""

    idle_w: float = 65.0
    peak_w: float = 250.0
    # weights of how much each engine contributes at full utilisation
    mxu_weight: float = 0.60
    hbm_weight: float = 0.30
    ici_weight: float = 0.10

    def step_power_w(self, compute_util: float, memory_util: float,
                     collective_util: float) -> float:
        u = (self.mxu_weight * min(compute_util, 1.0)
             + self.hbm_weight * min(memory_util, 1.0)
             + self.ici_weight * min(collective_util, 1.0))
        # activation floor: a running chip never sits at idle power
        floor = 0.15
        return self.idle_w + (self.peak_w - self.idle_w) * (
            floor + (1.0 - floor) * u)


@dataclasses.dataclass(frozen=True)
class StepActivity:
    """Roofline terms for one step (seconds of each bottleneck)."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def step_time_s(self) -> float:
        # perfectly overlapped lower bound: the roofline step time
        return max(self.compute_s, self.memory_s, self.collective_s)

    def utilisations(self) -> tuple[float, float, float]:
        t = max(self.step_time_s, 1e-12)
        return (self.compute_s / t, self.memory_s / t, self.collective_s / t)


def steps_timeline(step: StepActivity, n_steps: int,
                   model: ChipPowerModel = ChipPowerModel(),
                   gap_s: float = 0.0, t0: float = 0.0) -> ActivityTimeline:
    """Activity timeline for ``n_steps`` identical steps."""
    cu, mu, xu = step.utilisations()
    p = model.step_power_w(cu, mu, xu)
    segs = []
    for _ in range(n_steps):
        segs.append((step.step_time_s, p))
        if gap_s > 0:
            segs.append((gap_s, model.idle_w))
    return from_segments(segs, t0=t0, idle_w=model.idle_w)


def phase_timeline(phases: list[StepActivity],
                   model: ChipPowerModel = ChipPowerModel(),
                   t0: float = 0.0) -> ActivityTimeline:
    """Multi-phase step (e.g. a prefill burst, then a decode stream)."""
    segs = []
    for ph in phases:
        cu, mu, xu = ph.utilisations()
        segs.append((ph.step_time_s, model.step_power_w(cu, mu, xu)))
    return from_segments(segs, t0=t0, idle_w=model.idle_w)
