"""Benchmark-load generators, in timeline form (the part of
:mod:`repro.core.load` the fleet audit, the scalar §5 protocols and their
tests use).

The scenario generators, their vectorised banks and
``FleetScenarioSpec`` are not ported yet (ROADMAP.md, queue A).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.ground_truth import ActivityTimeline, from_segments


def square_wave(period_s: float, n_cycles: int, p_high: float,
                p_low: float = 60.0, duty: float = 0.5, t0: float = 0.0,
                idle_w: float = 60.0) -> ActivityTimeline:
    """High/low square wave (the reference's without its period jitter)."""
    segs = []
    for _ in range(n_cycles):
        segs.append((max(1e-4, period_s * duty), p_high))
        segs.append((max(1e-4, period_s * (1 - duty)), p_low))
    return from_segments(segs, t0=t0, idle_w=idle_w)


def workload_burst(duration_s: float, p_active: float,
                   idle_w: float = 60.0) -> ActivityTimeline:
    """One repetition of a real workload modelled as a constant-power
    burst (the paper's per-kernel execution window)."""
    return from_segments([(duration_s, p_active)], idle_w=idle_w)


def multi_phase_workload(phases: List[Tuple[float, float]],
                         idle_w: float = 60.0) -> ActivityTimeline:
    """A workload with several internal phases (e.g. compute-bound matmul
    then memory-bound softmax) — (duration_s, watts) list."""
    return from_segments(phases, idle_w=idle_w)
