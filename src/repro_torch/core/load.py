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
draw per cycle.

The mixed fleet's scenarios (training steps, bursty serving, idle
maintenance, diurnal plateaus; DVFS ramps, thermal sag, power-cap
clipping, node failures) are synthesised as banks: ``[N]`` devices at
once, on the device the caller names, each device's shape drawn from its
own scenario seed (:class:`ScenarioStreams`).  The scalar generators are
row 0 of the bank at ``[seed]``.  :class:`FleetScenarioSpec` describes a
fleet by recipe, so ``fleet_audit`` and ``stream_fleet`` synthesise each
device slab on demand.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.common import spans
from repro_torch.core.ground_truth import (ActivityTimeline, TimelineBank,
                                           from_segments)
from repro_torch.core.meter import Workload, WorkloadSet
from repro_torch.engine_backend import keyed_rng

F64 = torch.float64
I64 = torch.int64


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


# ---------------------------------------------------------------------------
# Scenario streams: each device's draws, keyed by its scenario seed
# ---------------------------------------------------------------------------

class ScenarioStreams:
    """``[N]`` scenario streams on one device: draw ``j`` of device ``i``
    is the keyed stream's uniform under key ``seeds[i]`` at counter
    ``(0, j, TAG_SCENARIO)``.  Each draw takes the next slot, and a block
    of ``width`` draws takes ``width`` slots whatever its counts, so a
    row's draws depend on its seed alone (the reference draws
    ``default_rng(seed_i)``; its tests carry those draws in through
    :func:`_scenario_streams`)."""

    def __init__(self, seeds: torch.Tensor):
        self.seeds = seeds
        self._slot = 0

    @property
    def n_lanes(self) -> int:
        return self.seeds.shape[0]

    @property
    def device(self) -> torch.device:
        return self.seeds.device

    def _units(self, width: int) -> torch.Tensor:
        """[N, width] uniforms at the next ``width`` slots."""
        dev = self.seeds.device
        slots = torch.arange(self._slot, self._slot + width, device=dev)
        self._slot += width
        keyed_rng.check_index("scenario slot", self._slot)
        return keyed_rng.uniform(self.seeds[:, None],
                                 torch.zeros((1, width), dtype=I64,
                                             device=dev),
                                 slots[None, :], keyed_rng.TAG_SCENARIO)

    def uniform(self, lo, hi) -> torch.Tensor:
        """One U[lo, hi) a lane (``lo``/``hi`` floats or [N])."""
        return lo + (hi - lo) * self._units(1)[:, 0]

    def uniform_block(self, lo, hi, counts: torch.Tensor,
                      width: int) -> torch.Tensor:
        """[N, width] U[lo, hi) draws, lane ``i``'s past ``counts[i]``
        zero."""
        out = lo + (hi - lo) * self._units(width)
        return torch.where(_live(counts, width), out, 0.0)

    def exponential_block(self, scale: float, counts: torch.Tensor,
                          width: int) -> torch.Tensor:
        """[N, width] exponentials of mean ``scale``, ``-scale·log1p(-u)``
        (:func:`_log_unit` of the exact ``1 - u``), lane ``i``'s past
        ``counts[i]`` zero."""
        out = -scale * _log_unit(1.0 - self._units(width))
        return torch.where(_live(counts, width), out, 0.0)

    def poisson(self, lam: float, cap: int) -> torch.Tensor:
        """[N] Poisson(``lam``) counts clipped at ``cap``: Knuth's product
        method cut at the clip, ``min(K, cap)`` = the number of
        ``j <= cap`` with ``u_1 ··· u_j > exp(-lam)``, over a fixed
        [N, cap] block (folded left, one column at a time, so the CPU and
        the card form the same products)."""
        u = self._units(cap)
        enlam = math.exp(-lam)
        prod = torch.ones(self.n_lanes, dtype=F64, device=u.device)
        k = torch.zeros(self.n_lanes, dtype=I64, device=u.device)
        for j in range(cap):
            prod = prod * u[:, j]
            k = k + (prod > enlam).to(I64)
        return k


#: ln 2 split so that ``e · _LN2_HI`` is exact for |e| < 2^11 (fdlibm's)
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_SQRT_HALF = 0.70710678118654752440


def _log_unit(x: torch.Tensor) -> torch.Tensor:
    """ln ``x`` for ``x`` in (0, 1], within a few ulp, in IEEE +, -, × and
    ÷ alone (one torch op each), so that the card and the CPU round it
    alike; their ``log``/``log1p`` may differ by an ulp.  ``x = m · 2^e``
    with ``m`` in [√½, √2), and ln m = 2 atanh(s), s = (m - 1)/(m + 1),
    summed to s^25."""
    m, e = torch.frexp(x)
    low = m < _SQRT_HALF
    m = torch.where(low, m * 2.0, m)
    e = (e - low.to(e.dtype)).to(F64)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    p = torch.full_like(z, 1.0 / 25.0)
    for k in range(11, -1, -1):
        p = p * z + 1.0 / (2 * k + 1)
    return e * _LN2_HI + (e * _LN2_LO + 2.0 * s * p)


def _live(counts: torch.Tensor, width: int) -> torch.Tensor:
    """[N, width]: column ``j`` of lane ``i`` is below ``counts[i]``."""
    cols = torch.arange(width, device=counts.device)
    return cols[None, :] < counts[:, None]


def _scenario_streams(seeds, device: torch.device) -> ScenarioStreams:
    """The scenario streams of ``seeds`` ([N] ints) on ``device``."""
    with spans.read("audit.synth"):
        keys = torch.as_tensor(np.asarray(seeds, dtype=np.int64),
                               device=device)
    return ScenarioStreams(keys)


# ---------------------------------------------------------------------------
# The scenario banks: [N] devices' timelines at once
# ---------------------------------------------------------------------------
# Each ``_*_parts`` draws in the reference's order (``repro.core.load``'s
# banks) and returns padded ``(edges [N, S+1], powers [N, S], n_segs [N])``
# on the streams' device; the public ``*_bank`` wraps them in a
# TimelineBank, and ``mixed_fleet_bank`` scatters each kind's into one
# slab.

Parts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _cum_edges(durs: torch.Tensor) -> torch.Tensor:
    """Edges ``[0, d0, d0 + d1, ...]`` folded left one column at a time,
    as ``from_segments`` and ``np.add.accumulate`` add (``torch.cumsum``
    on the card sums in another order)."""
    cols = [torch.zeros(durs.shape[0], dtype=F64, device=durs.device)]
    for j in range(durs.shape[1]):
        cols.append(cols[-1] + durs[:, j])
    return torch.stack(cols, dim=1)


def _fixed(durs: torch.Tensor, powers: torch.Tensor) -> Parts:
    """Parts of a kind whose every row has all ``S`` segments."""
    n, s = powers.shape
    return (_cum_edges(durs), powers,
            torch.full((n,), s, dtype=I64, device=powers.device))


def _steps(streams: ScenarioStreams, window_s: float,
           n_steps: int) -> torch.Tensor:
    """[N, n_steps] equal dwells of ``window_s / n_steps``."""
    return torch.full((streams.n_lanes, n_steps), window_s / n_steps,
                      dtype=F64, device=streams.device)


def _linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    """``np.linspace(start, stop, n)`` bit for bit: ``i · step + start``,
    the last point ``stop``."""
    step = (stop - start) / (n - 1) if n > 1 else 0.0
    pts = [i * step + start for i in range(n)]
    if n > 1:
        pts[-1] = stop
    with spans.read("audit.synth"):
        return torch.tensor(pts, dtype=F64, device=device)


def _training_parts(streams, idle_w=60.0, peak_w=250.0) -> Parts:
    compute = streams.uniform(0.100, 0.160)
    collective = streams.uniform(0.040, 0.080)
    p_hi = peak_w * streams.uniform(0.82, 0.95)
    p_lo = peak_w * streams.uniform(0.55, 0.70)
    return _fixed(torch.stack([compute, collective], dim=1),
                  torch.stack([p_hi, p_lo], dim=1))


def _inference_parts(streams, window_s=0.350, rate_hz=14.0, idle_w=60.0,
                     peak_w=250.0, max_bursts=12) -> Parts:
    """The serving window's bursts merged as the scalar loop merges them,
    with vector state over devices for ``max_bursts`` steps; emitted
    segments are compacted to each row's prefix by an exact scatter (each
    row's targets are unique; the others land in a column that is
    dropped).  One host read: the widest row."""
    if max_bursts < 1:
        raise ValueError(f"max_bursts must be >= 1, got {max_bursts}")
    n, dev, w = streams.n_lanes, streams.device, max_bursts
    k = streams.poisson(rate_hz * window_s, max_bursts)
    p_hi = peak_w * streams.uniform(0.75, 0.92)
    arrivals = streams.uniform_block(0.0, window_s, k, w)
    arrivals = torch.where(_live(k, w), arrivals, math.inf)
    arrivals = torch.sort(arrivals, dim=1).values
    lengths = torch.clamp_min(streams.exponential_block(0.012, k, w), 0.002)

    zero = torch.zeros(n, dtype=F64, device=dev)
    idle = torch.full((n,), idle_w, dtype=F64, device=dev)
    dur, pw, emit = [], [], []
    cursor = zero
    busy_until = zero
    for j in range(w):
        live = k > j
        a = torch.where(live, arrivals[:, j], 0.0)
        d = torch.where(live, lengths[:, j], 0.0)
        end = torch.clamp_max(a + d, window_s)
        gap = live & (a > busy_until)
        dur.append(torch.where(gap, a - cursor, 0.0))
        pw.append(idle)
        emit.append(gap)
        cursor = torch.where(gap, a, cursor)
        end = torch.maximum(end, busy_until)
        burst = live & (end > cursor)
        dur.append(torch.where(burst, end - cursor, 0.0))
        pw.append(torch.where(burst, p_hi, idle_w))
        emit.append(burst)
        cursor = torch.where(burst, end, cursor)
        busy_until = torch.where(live, torch.maximum(busy_until, end),
                                 busy_until)
    tail = cursor < window_s
    dur.append(torch.where(tail, window_s - cursor, 0.0))
    pw.append(idle)
    emit.append(tail)
    dur = torch.stack(dur, dim=1)
    pw = torch.stack(pw, dim=1)
    emit = torch.stack(emit, dim=1)
    # k == 0 rows: the scalar path emits exactly [(window_s, idle_w)]
    first = torch.arange(2 * w + 1, device=dev)[None, :] == 0
    none = (k == 0)[:, None]
    emit = torch.where(none, first, emit)
    dur = torch.where(none & first, window_s, dur)
    pw = torch.where(none & first, idle_w, pw)

    n_segs = emit.sum(dim=1)
    with spans.read("audit.synth"):
        smax = int(n_segs.max())
    slots = torch.where(emit, torch.cumsum(emit, dim=1) - 1, smax)
    out_dur = torch.zeros((n, smax + 1), dtype=F64, device=dev)
    out_pw = torch.full((n, smax + 1), idle_w, dtype=F64, device=dev)
    out_dur.scatter_(1, slots, dur)
    out_pw.scatter_(1, slots, pw)
    return _cum_edges(out_dur[:, :smax]), out_pw[:, :smax], n_segs


def _idle_parts(streams, window_s=0.450, idle_w=60.0, peak_w=250.0) -> Parts:
    blip = streams.uniform(0.015, 0.035)
    at = streams.uniform(0.0, window_s - blip)
    p_blip = idle_w + (peak_w - idle_w) * streams.uniform(0.2, 0.4)
    p_floor = idle_w * streams.uniform(1.0, 1.15)
    return _fixed(torch.stack([at, blip, (window_s - at) - blip], dim=1),
                  torch.stack([p_floor, p_blip, p_floor], dim=1))


def _diurnal_parts(streams, window_s=0.300, idle_w=60.0, peak_w=250.0,
                   n_steps=6) -> Parts:
    phase = streams.uniform(0.0, 2.0 * math.pi)
    depth = streams.uniform(0.5, 0.9)
    hours = phase[:, None] + _linspace(0.0, math.pi / 3.0, n_steps,
                                       phase.device)[None, :]
    util = 0.5 * (1.0 + torch.sin(hours)) * depth[:, None]
    floor = 0.15 * (peak_w - idle_w)
    amp = idle_w + floor + (peak_w - idle_w - floor) * util
    amp = torch.where(util <= 0.0, idle_w, amp)
    return _fixed(_steps(streams, window_s, n_steps), amp)


def _dvfs_parts(streams, window_s=0.360, idle_w=60.0, peak_w=250.0,
                n_steps=8) -> Parts:
    lo_f = streams.uniform(0.30, 0.45)
    hi_f = streams.uniform(0.85, 0.97)
    gamma = streams.uniform(0.6, 1.6)
    up = streams.uniform(0.0, 1.0) < 0.5
    frac = _linspace(0.0, 1.0, n_steps, lo_f.device)
    p = peak_w * (lo_f[:, None]
                  + (hi_f - lo_f)[:, None] * frac[None, :] ** gamma[:, None])
    p = torch.where(up[:, None], p, p.flip(1))
    return _fixed(_steps(streams, window_s, n_steps), p)


def _throttle_parts(streams, window_s=0.420, idle_w=60.0, peak_w=250.0,
                    n_steps=7) -> Parts:
    p0 = streams.uniform(0.88, 0.97)
    p_inf = streams.uniform(0.60, 0.75)
    tau = streams.uniform(0.25, 0.60)
    mid = torch.tensor([(i + 0.5) * (window_s / n_steps)
                        for i in range(n_steps)], dtype=F64, device=p0.device)
    sag = torch.exp(-mid[None, :] / (window_s * tau)[:, None])
    p = peak_w * (p_inf[:, None] + (p0 - p_inf)[:, None] * sag)
    return _fixed(_steps(streams, window_s, n_steps), p)


def _power_cap_parts(streams, window_s=0.400, idle_w=60.0, peak_w=250.0,
                     n_steps=8) -> Parts:
    counts = torch.full((streams.n_lanes,), n_steps, dtype=I64,
                        device=streams.device)
    demand_f = streams.uniform_block(0.55, 1.05, counts, n_steps)
    cap_f = streams.uniform(0.70, 0.85)
    demand = idle_w + (peak_w - idle_w) * demand_f
    p = torch.minimum(demand, (peak_w * cap_f)[:, None])
    return _fixed(_steps(streams, window_s, n_steps), p)


def _node_failure_parts(streams, window_s=0.400, idle_w=60.0,
                        peak_w=250.0) -> Parts:
    p_run = peak_w * streams.uniform(0.78, 0.94)
    at = window_s * streams.uniform(0.20, 0.85)
    p_dead = idle_w * streams.uniform(0.02, 0.10)
    return _fixed(torch.stack([at, window_s - at], dim=1),
                  torch.stack([p_run, p_dead], dim=1))


_PARTS = {
    "training": _training_parts,
    "inference": _inference_parts,
    "idle": _idle_parts,
    "diurnal": _diurnal_parts,
    "dvfs": _dvfs_parts,
    "throttle": _throttle_parts,
    "powercap": _power_cap_parts,
    "node_failure": _node_failure_parts,
}


def _bank(kind: str, seeds, device: DeviceLike, idle_w: float,
          **kw) -> TimelineBank:
    """Kind ``kind``'s bank of ``seeds`` on ``device``."""
    dev = resolve_device(device)
    edges, powers, n_segs = _PARTS[kind](_scenario_streams(seeds, dev),
                                         idle_w=idle_w, **kw)
    return TimelineBank(edges, powers,
                        torch.full((powers.shape[0],), idle_w, dtype=F64,
                                   device=dev), n_segs)


def training_step_bank(seeds, idle_w: float = 60.0, peak_w: float = 250.0,
                       *, device: DeviceLike = "cuda") -> TimelineBank:
    """Training steps: a compute-bound phase near peak, then a collective
    phase at lower draw, with per-device jitter in both."""
    return _bank("training", seeds, device, idle_w, peak_w=peak_w)


def inference_serving_bank(seeds, window_s: float = 0.350,
                           rate_hz: float = 14.0, idle_w: float = 60.0,
                           peak_w: float = 250.0, max_bursts: int = 12, *,
                           device: DeviceLike = "cuda") -> TimelineBank:
    """A serving window with K ~ Poisson(rate · window) request bursts
    (clipped at ``max_bursts``) at uniform times, each a short
    high-power burst; overlapping bursts merge."""
    return _bank("inference", seeds, device, idle_w, window_s=window_s,
                 rate_hz=rate_hz, peak_w=peak_w, max_bursts=max_bursts)


def idle_maintenance_bank(seeds, window_s: float = 0.450,
                          idle_w: float = 60.0, peak_w: float = 250.0, *,
                          device: DeviceLike = "cuda") -> TimelineBank:
    """A drained device: near idle with one short health-check blip."""
    return _bank("idle", seeds, device, idle_w, window_s=window_s,
                 peak_w=peak_w)


def diurnal_cycle_bank(seeds, window_s: float = 0.300, idle_w: float = 60.0,
                       peak_w: float = 250.0, n_steps: int = 6, *,
                       device: DeviceLike = "cuda") -> TimelineBank:
    """A slice of a sinusoidal day curve at a random hour, in plateaus."""
    return _bank("diurnal", seeds, device, idle_w, window_s=window_s,
                 peak_w=peak_w, n_steps=n_steps)


def dvfs_ramp_bank(seeds, window_s: float = 0.360, idle_w: float = 60.0,
                   peak_w: float = 250.0, n_steps: int = 8, *,
                   device: DeviceLike = "cuda") -> TimelineBank:
    """A DVFS ramp: a curved staircase of ``n_steps`` p-states, up or
    down."""
    return _bank("dvfs", seeds, device, idle_w, window_s=window_s,
                 peak_w=peak_w, n_steps=n_steps)


def thermal_throttle_bank(seeds, window_s: float = 0.420,
                          idle_w: float = 60.0, peak_w: float = 250.0,
                          n_steps: int = 7, *,
                          device: DeviceLike = "cuda") -> TimelineBank:
    """Thermal sag: near peak, decaying exponentially to a throttled
    level."""
    return _bank("throttle", seeds, device, idle_w, window_s=window_s,
                 peak_w=peak_w, n_steps=n_steps)


def power_cap_bank(seeds, window_s: float = 0.400, idle_w: float = 60.0,
                   peak_w: float = 250.0, n_steps: int = 8, *,
                   device: DeviceLike = "cuda") -> TimelineBank:
    """Power-cap clipping: fluctuating demand clipped at the board
    limit."""
    return _bank("powercap", seeds, device, idle_w, window_s=window_s,
                 peak_w=peak_w, n_steps=n_steps)


def node_failure_bank(seeds, window_s: float = 0.400, idle_w: float = 60.0,
                      peak_w: float = 250.0, *,
                      device: DeviceLike = "cuda") -> TimelineBank:
    """A node failing mid-window: full load, then a PSU/fan trickle."""
    return _bank("node_failure", seeds, device, idle_w, window_s=window_s,
                 peak_w=peak_w)


SCENARIO_BANKS = {
    "training": training_step_bank,
    "inference": inference_serving_bank,
    "idle": idle_maintenance_bank,
    "diurnal": diurnal_cycle_bank,
    "dvfs": dvfs_ramp_bank,
    "throttle": thermal_throttle_bank,
    "powercap": power_cap_bank,
    "node_failure": node_failure_bank,
}


def scenario_bank(kind: str, seeds, idle_w: float = 60.0,
                  peak_w: float = 250.0, *,
                  device: DeviceLike = "cuda") -> TimelineBank:
    """Kind ``kind``'s bank: row ``i`` is ``scenario_timeline(kind,
    seed=seeds[i])``."""
    try:
        builder = SCENARIO_BANKS[kind]
    except KeyError:
        raise KeyError(f"unknown scenario '{kind}'; "
                       f"available: {sorted(SCENARIO_BANKS)}") from None
    return builder(seeds, idle_w=idle_w, peak_w=peak_w, device=device)


# ---------------------------------------------------------------------------
# Scalar generators: one device's fragment, row 0 of its kind's bank
# ---------------------------------------------------------------------------

def training_step_timeline(seed: int = 0, idle_w: float = 60.0,
                           peak_w: float = 250.0) -> ActivityTimeline:
    """One training step (row 0 of :func:`training_step_bank`)."""
    return training_step_bank([seed], idle_w, peak_w, device="cpu").row(0)


def inference_serving_timeline(seed: int = 0, window_s: float = 0.350,
                               rate_hz: float = 14.0, idle_w: float = 60.0,
                               peak_w: float = 250.0,
                               max_bursts: int = 12) -> ActivityTimeline:
    """One serving window (row 0 of :func:`inference_serving_bank`).  The
    clip at ``max_bursts`` truncates the Poisson tail: raise it when
    ``rate_hz · window_s`` approaches it."""
    return inference_serving_bank([seed], window_s, rate_hz, idle_w,
                                  peak_w, max_bursts, device="cpu").row(0)


def idle_maintenance_timeline(seed: int = 0, window_s: float = 0.450,
                              idle_w: float = 60.0,
                              peak_w: float = 250.0) -> ActivityTimeline:
    """One drained device (row 0 of :func:`idle_maintenance_bank`)."""
    return idle_maintenance_bank([seed], window_s, idle_w, peak_w,
                                 device="cpu").row(0)


def diurnal_cycle_timeline(seed: int = 0, window_s: float = 0.300,
                           idle_w: float = 60.0, peak_w: float = 250.0,
                           n_steps: int = 6) -> ActivityTimeline:
    """One diurnal slice (row 0 of :func:`diurnal_cycle_bank`)."""
    return diurnal_cycle_bank([seed], window_s, idle_w, peak_w, n_steps,
                              device="cpu").row(0)


def dvfs_ramp_timeline(seed: int = 0, window_s: float = 0.360,
                       idle_w: float = 60.0, peak_w: float = 250.0,
                       n_steps: int = 8) -> ActivityTimeline:
    """One DVFS ramp (row 0 of :func:`dvfs_ramp_bank`)."""
    return dvfs_ramp_bank([seed], window_s, idle_w, peak_w, n_steps,
                          device="cpu").row(0)


def thermal_throttle_timeline(seed: int = 0, window_s: float = 0.420,
                              idle_w: float = 60.0, peak_w: float = 250.0,
                              n_steps: int = 7) -> ActivityTimeline:
    """One thermal sag (row 0 of :func:`thermal_throttle_bank`)."""
    return thermal_throttle_bank([seed], window_s, idle_w, peak_w,
                                 n_steps, device="cpu").row(0)


def power_cap_timeline(seed: int = 0, window_s: float = 0.400,
                       idle_w: float = 60.0, peak_w: float = 250.0,
                       n_steps: int = 8) -> ActivityTimeline:
    """One power-capped window (row 0 of :func:`power_cap_bank`)."""
    return power_cap_bank([seed], window_s, idle_w, peak_w, n_steps,
                          device="cpu").row(0)


def node_failure_timeline(seed: int = 0, window_s: float = 0.400,
                          idle_w: float = 60.0,
                          peak_w: float = 250.0) -> ActivityTimeline:
    """One node failure (row 0 of :func:`node_failure_bank`)."""
    return node_failure_bank([seed], window_s, idle_w, peak_w,
                             device="cpu").row(0)


SCENARIOS = {
    "training": training_step_timeline,
    "inference": inference_serving_timeline,
    "idle": idle_maintenance_timeline,
    "diurnal": diurnal_cycle_timeline,
    "dvfs": dvfs_ramp_timeline,
    "throttle": thermal_throttle_timeline,
    "powercap": power_cap_timeline,
    "node_failure": node_failure_timeline,
}

DEFAULT_MIX = {"training": 0.40, "inference": 0.30,
               "idle": 0.15, "diurnal": 0.15}

#: an all-adversarial fleet for resilience drills: every device is
#: mid-ramp, throttling, capped or dying
ADVERSARIAL_MIX = {"dvfs": 0.30, "throttle": 0.25,
                   "powercap": 0.25, "node_failure": 0.20}


def scenario_timeline(kind: str, seed: int = 0, idle_w: float = 60.0,
                      peak_w: float = 250.0) -> ActivityTimeline:
    """One device's repetition fragment for a named scenario."""
    try:
        builder = SCENARIOS[kind]
    except KeyError:
        raise KeyError(f"unknown scenario '{kind}'; "
                       f"available: {sorted(SCENARIOS)}") from None
    return builder(seed=seed, idle_w=idle_w, peak_w=peak_w)


# ---------------------------------------------------------------------------
# The mixed fleet
# ---------------------------------------------------------------------------

def _mix_labels(n: int, mix: Optional[Dict[str, float]],
                seed: int) -> np.ndarray:
    """The per-device scenario assignment, on the host: largest-remainder
    apportioning of ``mix`` over ``n`` devices, shuffled by
    ``default_rng(seed).permutation`` so profiles and scenarios
    decorrelate.  Returns an ``[n]`` array of kind labels."""
    if n < 1:
        raise ValueError("need at least one device")
    mix = dict(DEFAULT_MIX if mix is None else mix)
    for kind in mix:
        if kind not in SCENARIOS:
            raise KeyError(f"unknown scenario '{kind}'; "
                           f"available: {sorted(SCENARIOS)}")
    total = sum(mix.values())
    if total <= 0:
        raise ValueError("scenario mix fractions must sum to > 0")
    kinds = sorted(mix)
    exact = np.array([mix[k] / total * n for k in kinds])
    counts = np.floor(exact).astype(int)
    rema = exact - counts
    for i in np.argsort(-rema)[: n - int(counts.sum())]:
        counts[i] += 1
    labels = np.repeat(np.array(kinds), counts)
    rng = np.random.default_rng(seed)
    return labels[rng.permutation(n)]


def mixed_fleet_bank(n: int, mix: Optional[Dict[str, float]] = None,
                     seed: int = 0, idle_w: float = 60.0,
                     peak_w: float = 250.0, lo: int = 0,
                     hi: Optional[int] = None, *,
                     device: DeviceLike = "cuda"
                     ) -> Tuple[TimelineBank, np.ndarray]:
    """The mixed fleet as one padded :class:`TimelineBank` on ``device``:
    device ``i`` runs ``scenario_timeline(labels[i], seed + 1 + i)``.

    Returns ``(bank, labels)``.  ``lo``/``hi`` select the device slab
    ``lo .. hi-1`` of the full fleet (the full bank's rows exactly).  Each
    kind's edges and powers are drawn on ``device`` and scattered into
    the slab's, which pads by repeating a row's last edge and holding
    ``idle_w``."""
    dev = resolve_device(device)
    labels = _mix_labels(n, mix, seed)
    hi = n if hi is None else hi
    if not (0 <= lo < hi <= n):
        raise ValueError(f"bad slab [{lo}, {hi}) for {n} devices")
    labels = labels[lo:hi]
    fleet_rows = np.arange(lo, hi)
    parts = []
    for kind in np.unique(labels):
        rows = np.flatnonzero(labels == kind)
        streams = _scenario_streams(seed + 1 + fleet_rows[rows], dev)
        with spans.read("audit.synth"):
            rows_t = torch.as_tensor(rows, device=dev)
        parts.append((rows_t, _PARTS[str(kind)](streams, idle_w=idle_w,
                                                peak_w=peak_w)))
    m = hi - lo
    smax = max(p.shape[1] for _, (_, p, _) in parts)
    edges = torch.zeros((m, smax + 1), dtype=F64, device=dev)
    powers = torch.full((m, smax), idle_w, dtype=F64, device=dev)
    n_segs = torch.empty(m, dtype=I64, device=dev)
    for rows, (e, p, ns) in parts:
        s = p.shape[1]
        edges[rows, :s + 1] = e
        edges[rows, s + 1:] = e[:, -1:]
        powers[rows, :s] = p
        n_segs[rows] = ns
    idle = torch.full((m,), idle_w, dtype=F64, device=dev)
    return TimelineBank(edges, powers, idle, n_segs), labels


def mixed_fleet_workloads(n: int, mix: Optional[Dict[str, float]] = None,
                          seed: int = 0, idle_w: float = 60.0,
                          peak_w: float = 250.0, as_bank: bool = False, *,
                          device: DeviceLike = "cuda"):
    """N per-device workloads drawn from a scenario mix, labelled for
    per-scenario error breakdowns: a list of
    :class:`~repro_torch.core.meter.Workload` (each timeline on the
    host), or with ``as_bank=True`` a
    :class:`~repro_torch.core.meter.WorkloadSet` on ``device``.  Either
    way the timelines are :func:`mixed_fleet_bank`'s rows."""
    bank, labels = mixed_fleet_bank(n, mix=mix, seed=seed, idle_w=idle_w,
                                    peak_w=peak_w, device=device)
    if as_bank:
        return WorkloadSet(bank=bank, scenarios=labels)
    edges, powers = bank.edges.cpu(), bank.powers.cpu()
    return [Workload(f"{kind}[{i}]",
                     ActivityTimeline(edges[i, :k + 1], powers[i, :k],
                                      idle_w),
                     scenario=str(kind))
            for i, (kind, k) in enumerate(zip(labels,
                                              bank.n_segs.tolist()))]


@dataclasses.dataclass(frozen=True)
class FleetScenarioSpec:
    """A mixed fleet described by recipe instead of materialised arrays.

    ``fleet_audit(workload=spec, chunk_devices=...)`` and
    ``stream_fleet(workload=spec, ...)`` synthesise each device slab on
    demand (:meth:`bank`), so a million-device audit never holds more
    than one slab's timelines.  Slabs are exact row ranges of the full
    fleet: any chunking gives the same rows bit for bit.
    """

    n: int
    mix: Optional[dict] = None
    seed: int = 0
    idle_w: float = 60.0
    peak_w: float = 250.0

    def __post_init__(self):
        if self.n < 1:
            raise ValueError("need at least one device")
        _mix_labels(1, self.mix, self.seed)     # validate the mix up front

    def bank(self, lo: int = 0, hi: Optional[int] = None, *,
             device: DeviceLike = "cuda") -> Tuple[TimelineBank, np.ndarray]:
        return mixed_fleet_bank(self.n, mix=self.mix, seed=self.seed,
                                idle_w=self.idle_w, peak_w=self.peak_w,
                                lo=lo, hi=hi, device=device)

    def workload_set(self, lo: int = 0, hi: Optional[int] = None, *,
                     device: DeviceLike = "cuda") -> WorkloadSet:
        """The slab as a :class:`~repro_torch.core.meter.WorkloadSet` on
        ``device``."""
        bank, labels = self.bank(lo, hi, device=device)
        return WorkloadSet(bank=bank, scenarios=labels)

    def iter_workload_sets(self, slabs, prefetch: bool = False, *,
                           device: DeviceLike = "cuda"):
        """Yield ``workload_set(lo, hi)`` for each ``(lo, hi)`` in
        ``slabs``.  With ``prefetch=True`` slab *k+1* is synthesised on a
        one-worker thread while the consumer works on slab *k*; every
        slab's rows draw from their own seeds, so the sequence is the
        same either way."""
        slabs = list(slabs)
        if not prefetch or len(slabs) <= 1:
            for lo, hi in slabs:
                yield self.workload_set(lo, hi, device=device)
            return
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self.workload_set, *slabs[0], device=device)
            for nxt in slabs[1:]:
                cur = fut.result()
                fut = pool.submit(self.workload_set, *nxt, device=device)
                yield cur
            yield fut.result()
