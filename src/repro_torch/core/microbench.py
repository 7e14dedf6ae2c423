"""Black-box sensor characterisation (the paper's §4 experiments).

The counterpart of :mod:`repro.core.microbench`, estimator for estimator.
Every estimator sees only the public query API of an
:class:`~repro_torch.core.sensor.OnboardSensor` (plus, where the paper
used one, a :class:`~repro_torch.core.ground_truth.GroundTruthMeter`),
and the hidden profile parameters are recovered:

* :func:`estimate_update_period`   — Fig. 6  (median run-length of constant readings)
* :func:`measure_transient`        — Fig. 7  (rise time + response class)
* :func:`estimate_steady_state`    — Fig. 8/9 (gain & offset by regression)
* :func:`estimate_boxcar_window`   — Figs. 10–13 (aliased square wave +
  boxcar emulation + Nelder–Mead MSE fit)
* :func:`characterise`             — the full suite → CalibrationRecord

Readings, masks and losses stay on the sensor's device; only scalars cross
to the host: medians, crossing times, Nelder–Mead's loss values (one
``float`` per evaluation) and the returned estimates.  Medians follow
``np.median`` (the mean of the two middle values), population standard
deviations ``np.std`` and the steady-state grid ``np.linspace``.  The
boxcar fit's repetition seeds come from the keyed stream
(:mod:`repro_torch.engine_backend.keyed_rng`) under its seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import load as loads
from repro_torch.core import neldermead
from repro_torch.core.ground_truth import ActivityTimeline, GroundTruthMeter
from repro_torch.core.sensor import OnboardSensor
from repro_torch.engine_backend import keyed_rng

F64 = torch.float64


def _median(x: torch.Tensor) -> torch.Tensor:
    """``np.median`` of ``x`` (flattened) as a 0-d tensor on its device:
    the middle value, or the mean of the two middle values; nan when
    ``x`` holds a nan or nothing."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    if n == 0:
        return torch.tensor(math.nan, dtype=s.dtype, device=s.device)
    h = n // 2
    med = s[h] if n % 2 else (s[h - 1] + s[h]) / 2
    return torch.where(torch.isnan(s[-1]), s[-1], med)


# ---------------------------------------------------------------------------
# 4.1 Power update period
# ---------------------------------------------------------------------------

def complete_run_durations(ts, vals) -> torch.Tensor:
    """Durations of *complete* runs of identical consecutive readings.

    A run is complete when it is bounded by a reading change on both
    sides: the first run starts at the poll grid's origin, not at a
    reading boundary (the sensor's phase truncates it by up to one
    period), and the last run is cut off by the capture end — both are
    dropped.  Takes tensors or arrays; returns a float64 tensor on the
    device of ``ts``.
    """
    ts = torch.as_tensor(ts, dtype=F64)
    vals = torch.as_tensor(vals, device=ts.device)
    change = torch.nonzero(torch.diff(vals) != 0.0).reshape(-1)
    if change.numel() < 2:
        return ts.new_empty(0)
    return torch.diff(ts[change])


def estimate_update_period(sensor: OnboardSensor,
                           query_period_s: float = 0.001,
                           duration_s: float = 8.0,
                           p_high: float = 220.0,
                           p_low: float = 70.0) -> float:
    """Drive a fast square wave and measure how often readings change.

    The paper queries at ~1 ms with a 20 ms square-wave load and takes the
    median length of runs of identical readings — complete runs only
    (see :func:`complete_run_durations`); fewer than three cannot
    support a median and report nan.
    """
    wave = loads.square_wave(period_s=0.020,
                             n_cycles=int(duration_s / 0.020),
                             p_high=p_high, p_low=p_low, seed=11)
    sensor.attach(wave, t_end=duration_s)
    ts, vals = sensor.poll(0.0, duration_s, period_s=query_period_s)
    periods = complete_run_durations(ts, vals)
    if periods.numel() < 3:
        return float("nan")
    return float(_median(periods))


# ---------------------------------------------------------------------------
# 4.2 Transient response
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransientResult:
    kind: str            # instant | linear | logarithmic
    rise_time_s: float   # 10 % -> 90 %
    delay_s: float       # load start -> first reading movement
    settle_w: float


def measure_transient(sensor: OnboardSensor,
                      update_period_s: float,
                      p_high: float = 220.0,
                      p_low: float = 70.0) -> TransientResult:
    """Single 6 s step (paper §4.2); classify the response shape."""
    t_on = 0.5
    tl = loads.step(t_on=t_on, duration_s=6.0, p_high=p_high, p_low=p_low)
    sensor.attach(tl, t_end=8.0)
    ts, vals = sensor.poll(0.0, 7.5, period_s=0.001)

    base, settle = torch.stack([
        _median(vals[ts < t_on]),
        _median(vals[(ts > t_on + 4.0) & (ts < t_on + 5.5)])]).tolist()
    span = settle - base
    if abs(span) < 1.0:
        return TransientResult("flat", float("nan"), float("nan"), settle)

    # first poll after t_on at or above base + frac·span, for the 10 %,
    # 90 % and 5 % thresholds at once (nan where none is)
    fracs = torch.tensor([0.10, 0.90, 0.05], dtype=F64, device=ts.device)
    hit = (ts > t_on)[None, :] & (vals[None, :]
                                  >= (base + fracs * span)[:, None])
    first = ts[hit.to(torch.int32).argmax(1)]
    t10, t90, t05 = torch.where(hit.any(1), first, math.nan).tolist()
    rise = t90 - t10
    delay = t05 - t_on

    # classification: within ~1 update period => the sensor publishes the
    # new level at its next tick ("instant"); ~1 s linear ramp => running
    # 1 s average; slower smooth approach => logarithmic capacitor charge
    if rise <= 1.5 * update_period_s:
        kind = "instant"
    else:
        # discriminate linear vs logarithmic by curvature of the ramp
        sel = (ts >= t10) & (ts <= t90)
        x = (ts[sel] - t10) / max(rise, 1e-9)
        y = (vals[sel] - base) / span
        lin_res = _residual(x, y, lambda x_, p: float(p[0]) * x_ + float(p[1]),
                            [(0.5, 1.5), (-0.5, 0.5)])
        log_res = _residual(
            x, y, lambda x_, p: 1.0 - torch.exp(-x_ / max(float(p[0]), 1e-3)),
            [(0.05, 2.0)])
        kind = "linear" if lin_res <= log_res else "logarithmic"
    return TransientResult(kind, rise, delay, settle)


def _residual(x: torch.Tensor, y: torch.Tensor,
              model: Callable[[torch.Tensor, np.ndarray], torch.Tensor],
              bounds: Sequence[tuple]) -> float:
    """The least mean squared residual of ``model`` on ``(x, y)`` over
    its bounded parameters, by Nelder–Mead from the bounds' midpoints."""
    x0 = [0.5 * (lo + hi) for lo, hi in bounds]
    res = neldermead.minimize(
        lambda p: float(torch.mean((model(x, p) - y) ** 2)),
        x0, bounds=bounds, initial_step=[0.2] * len(x0), max_iter=200)
    return res.fun


# ---------------------------------------------------------------------------
# 4.2 Steady-state error (needs a ground-truth meter, like the paper's PMD)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SteadyStateResult:
    gain: float
    offset_w: float
    r2: float
    levels_sensor: torch.Tensor
    levels_truth: torch.Tensor


def _linspace_rows(t0: Sequence[float], t1: Sequence[float], num: int,
                   device) -> torch.Tensor:
    """``np.linspace(t0[i], t1[i], num)`` per row [len(t0), num]:
    ``start + i·step`` with the last point set to ``stop``, as numpy
    builds it (``torch.linspace`` rounds differently)."""
    a = torch.tensor(t0, dtype=F64, device=device)[:, None]
    b = torch.tensor(t1, dtype=F64, device=device)
    step = torch.tensor([(hi - lo) / (num - 1) for lo, hi in zip(t0, t1)],
                        dtype=F64, device=device)[:, None]
    grid = torch.arange(num, dtype=F64, device=device)[None, :] * step + a
    grid[:, -1] = b
    return grid


def estimate_steady_state(sensor: OnboardSensor,
                          meter: GroundTruthMeter,
                          fractions: Sequence[float] = (0.0, 0.01, 0.2, 0.4,
                                                        0.6, 0.8, 1.0),
                          repeats: int = 8,
                          dwell_s: float = 4.0,
                          idle_w: float = 60.0,
                          peak_w: float = 250.0) -> SteadyStateResult:
    """Hold plateaus at SM-count fractions; regress sensor vs truth (Fig. 8).

    The fit is the least-squares line of the sensor's plateau means on the
    meter's, in float64 on the device (centred sums, the exact solution
    ``np.linalg.lstsq`` approximates).
    """
    levels = [loads.amplitude_for_fraction(f, idle_w, peak_w)
              for f in fractions] * repeats
    tl = loads.plateaus(levels, dwell_s=dwell_s, idle_w=idle_w, gap_s=0.5)
    sensor.attach(tl)
    windows = []
    cursor = 0.0
    for _ in levels:
        # discard the first 1.5 s of each plateau (rise + averaging window)
        windows.append((cursor + 1.5, cursor + dwell_s))
        cursor += dwell_s + 0.5
    t0s, t1s = [w[0] for w in windows], [w[1] for w in windows]
    y = sensor.query(_linspace_rows(t0s, t1s, 64, sensor.device)).mean(1)
    x = torch.stack([meter.trace(tl, t0, t1)[1].mean()
                     for t0, t1 in windows]).to(y.device)
    xm, ym = x.mean(), y.mean()
    dx = x - xm
    gain = (dx * (y - ym)).sum() / (dx * dx).sum()
    offset = ym - gain * xm
    pred = gain * x + offset
    gain, offset, ss_res, ss_tot = torch.stack([
        gain, offset, ((y - pred) ** 2).sum(), ((y - ym) ** 2).sum()]).tolist()
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    return SteadyStateResult(gain, offset, r2, y, x)


# ---------------------------------------------------------------------------
# 4.3 Boxcar averaging window
# ---------------------------------------------------------------------------

def _emulate_boxcar(reference: ActivityTimeline, ticks: torch.Tensor,
                    window_s: float) -> torch.Tensor:
    """The paper's emulation model: for each sensor timestamp, average the
    reference trace over the trailing candidate window."""
    return reference.mean_power(ticks - window_s, ticks)


def _normalise(v: torch.Tensor) -> torch.Tensor:
    s = torch.std(v, correction=0)
    return (v - v.mean()) / torch.where(s > 1e-9, s, 1.0)


def _repetition_seeds(seed: int, n: int) -> List[int]:
    """``n`` seeds in [0, 2^31), one per boxcar repetition: the keyed
    stream of key ``seed`` at slots ``0 .. n-1`` under ``TAG_REPEAT``."""
    keyed_rng.check_index("repetition", n - 1)
    u = keyed_rng.uniform(seed, torch.zeros(n, dtype=torch.int64),
                          torch.arange(n), keyed_rng.TAG_REPEAT)
    return torch.floor(u * 2.0 ** 31).to(torch.int64).tolist()


def estimate_boxcar_window(sensor: OnboardSensor,
                           update_period_s: float,
                           fractions: Sequence[float] = (2 / 3, 3 / 4, 4 / 5,
                                                         6 / 5, 5 / 4, 4 / 3),
                           repetitions: int = 8,
                           duration_s: float = 9.0,
                           p_high: float = 220.0,
                           p_low: float = 70.0,
                           seed: int = 0) -> tuple:
    """Recover W by the paper's aliasing + emulation + Nelder–Mead recipe.

    Returns (median window estimate, all samples as a numpy array).  The
    reference used for emulation is the *commanded square wave* — the
    paper shows (Fig. 12) this matches using PMD data, enabling PMD-free
    characterisation.  Every repetition has its seed, also one that
    yields too few ticks to fit.
    """
    T = update_period_s
    estimates: List[float] = []
    seeds = _repetition_seeds(seed, repetitions)
    for rep in range(repetitions):
        frac = fractions[rep % len(fractions)]
        period = frac * T
        wave = loads.square_wave(
            period_s=period, n_cycles=int(duration_s / period),
            p_high=p_high, p_low=p_low,
            period_jitter_s=0.002, seed=seeds[rep])
        sensor.attach(wave, t_end=duration_s + 1.0)
        ts, vals = sensor.poll(0.0, duration_s, period_s=0.001)
        # keep one sample per sensor update: timestamps where value changed
        chg = torch.nonzero(torch.diff(vals) != 0.0).reshape(-1) + 1
        ticks, obs = ts[chg], vals[chg]
        # discard the first second (paper step 4), need enough ticks
        keep = ticks > 1.0
        ticks, obs = ticks[keep], obs[keep]
        if ticks.numel() < 8:
            continue
        obs_n = _normalise(obs)

        def loss(w: float) -> float:
            em = _emulate_boxcar(wave, ticks, max(w, 1e-4))
            return float(torch.mean((_normalise(em) - obs_n) ** 2))

        # multi-start Nelder–Mead: the loss is multimodal when W ≈ T
        # (aliasing harmonics), so seed from several window fractions and
        # keep the best minimum
        best = None
        for x0 in (0.25 * T, 0.5 * T, 0.9 * T, 1.2 * T):
            res = neldermead.minimize_scalar(loss, x0=x0, lo=1e-3,
                                             hi=2.0 * T,
                                             initial_step=0.2 * T)
            if best is None or res.fun < best.fun:
                best = res
        estimates.append(float(best.x[0]))
    arr = np.asarray(estimates)
    return float(np.median(arr)), arr


# ---------------------------------------------------------------------------
# Full characterisation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CharacterisationResult:
    update_period_s: float
    transient: TransientResult
    window_s: Optional[float]
    gain: Optional[float]
    offset_w: Optional[float]
    r2: Optional[float]
    sampled_fraction: float


def characterise(sensor: OnboardSensor,
                 meter: Optional[GroundTruthMeter] = None,
                 boxcar_reps: int = 8) -> CharacterisationResult:
    """Run the full micro-benchmark suite on one device."""
    T = estimate_update_period(sensor)
    tr = measure_transient(sensor, T)
    window: Optional[float] = None
    if tr.kind == "instant":
        window, _ = estimate_boxcar_window(sensor, T, repetitions=boxcar_reps)
    elif tr.kind == "linear":
        window = tr.rise_time_s  # running average over ~rise time (1 s class)
    gain = offset = r2 = None
    if meter is not None:
        ss = estimate_steady_state(sensor, meter)
        gain, offset, r2 = ss.gain, ss.offset_w, ss.r2
    frac = 1.0 if window is None else min(1.0, window / T)
    return CharacterisationResult(T, tr, window, gain, offset, r2, frac)
