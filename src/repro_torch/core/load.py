"""Benchmark-load generators, in timeline form (the part of
:mod:`repro.core.load` the fleet audit, the scalar §5 protocols, the
black-box characterisation and their tests use).

The paper's load is a square wave: the high state is a data-dependent FMA
chain whose duration is linear in chain length and whose amplitude is set
by the fraction of SMs activated; the low state is a timed sleep.  Here the
same loads are timelines; the live load on the card is the CUDA
``fma_chain`` kernel (:mod:`repro_torch.kernels.fma_chain`).

A square wave's period jitter comes from the keyed stream
(:mod:`repro_torch.engine_backend.keyed_rng`) under the wave's seed, one
draw per cycle.  The scenario generators, their vectorised banks and
``FleetScenarioSpec`` are not ported yet (ROADMAP.md, queue A).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.core.ground_truth import ActivityTimeline, from_segments
from repro_torch.engine_backend import keyed_rng


def amplitude_for_fraction(fraction: float, idle_w: float = 60.0,
                           peak_w: float = 250.0) -> float:
    """Power drawn when ``fraction`` of the compute units run the FMA chain.

    Fig. 8 shows roughly equally-spaced plateaus for 20/40/60/80/100 % of
    SMs — i.e. near-linear — with idle further away (lower p-state),
    modelled by a small activation floor.
    """
    if fraction <= 0.0:
        return idle_w
    floor = 0.15 * (peak_w - idle_w)
    return idle_w + floor + (peak_w - idle_w - floor) * float(fraction)


def _period_jitter(seed: int, n_cycles: int, jitter_s: float) -> List[float]:
    """``n_cycles`` U[-jitter_s, jitter_s) draws: the keyed stream of key
    ``seed`` at slots ``0 .. n_cycles-1`` under ``TAG_PERIOD``."""
    keyed_rng.check_index("cycle", n_cycles - 1)
    u = keyed_rng.uniform(seed, torch.zeros(n_cycles, dtype=torch.int64),
                          torch.arange(n_cycles), keyed_rng.TAG_PERIOD)
    return (-jitter_s + (jitter_s - -jitter_s) * u).tolist()


def square_wave(period_s: float, n_cycles: int, p_high: float,
                p_low: float = 60.0, duty: float = 0.5, t0: float = 0.0,
                idle_w: float = 60.0, period_jitter_s: float = 0.0,
                seed: int = 0) -> ActivityTimeline:
    """High/low square wave; the jitter (drawn per cycle, added to the
    high state) models the imperfect kernel-length control that produced
    the paper's aliasing discovery (§4.3)."""
    jitter = (_period_jitter(seed, n_cycles, period_jitter_s)
              if period_jitter_s else [0.0] * n_cycles)
    segs = []
    for jit in jitter:
        segs.append((max(1e-4, period_s * duty + jit), p_high))
        segs.append((max(1e-4, period_s * (1 - duty)), p_low))
    return from_segments(segs, t0=t0, idle_w=idle_w)


def step(t_on: float, duration_s: float, p_high: float,
         p_low: float = 60.0, idle_w: float = 60.0,
         tail_s: float = 1.0) -> ActivityTimeline:
    """Single step for transient-response probing (the paper uses 6 s)."""
    return from_segments(
        [(t_on, p_low), (duration_s, p_high), (tail_s, p_low)],
        t0=0.0, idle_w=idle_w)


def plateaus(levels_w: List[float], dwell_s: float = 4.0,
             idle_w: float = 60.0, gap_s: float = 1.0) -> ActivityTimeline:
    """Steady plateaus for steady-state gain/offset regression (Fig. 8)."""
    segs = []
    for w in levels_w:
        segs.append((dwell_s, w))
        segs.append((gap_s, idle_w))
    return from_segments(segs, idle_w=idle_w)


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
