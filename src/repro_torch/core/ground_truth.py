"""Ground-truth power: activity timelines, stacked timeline banks and the
external-meter analogue.

The counterparts of :mod:`repro.core.ground_truth`.  An
:class:`ActivityTimeline` is a small description (float64 tensors on the
CPU) whose queries run on the device of the query times; a
:class:`TimelineBank` holds ``N`` padded traces on a device and answers
exact integrals there.  :class:`GroundTruthMeter` plays the paper's PMD:
a quantised, noisy 5 kHz sampling of a timeline, its ADC noise drawn from
the keyed stream (:mod:`repro_torch.engine_backend.keyed_rng`) with the
meter's seed as the key and the sample index as the counter.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.common import spans
from repro_torch.common.config import Config
from repro_torch.engine_backend import keyed_rng
from repro_torch.engine_backend.pytrees import TimelineArrays
from repro_torch.engine_backend.torch_backend import (searchsorted_rows,
                                                      timeline_integral)

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class ActivityTimeline:
    """Piecewise-constant power profile P(t): ``powers[i]`` holds on
    ``[edges[i], edges[i+1])``; outside the covered range the profile is
    ``idle_w``."""

    edges: torch.Tensor
    powers: torch.Tensor
    idle_w: float = 60.0

    def __post_init__(self):
        e = torch.as_tensor(self.edges, dtype=F64).cpu()
        p = torch.as_tensor(self.powers, dtype=F64).cpu()
        if e.ndim != 1 or p.ndim != 1 or e.shape[0] != p.shape[0] + 1:
            raise ValueError(f"bad timeline shapes {tuple(e.shape)} "
                             f"{tuple(p.shape)}")
        if bool((torch.diff(e) < -1e-12).any()):
            raise ValueError("edges must be non-decreasing")
        object.__setattr__(self, "edges", e)
        object.__setattr__(self, "powers", p)
        object.__setattr__(self, "idle_w", float(self.idle_w))

    @property
    def t_end(self) -> float:
        return float(self.edges[-1])

    @property
    def t_start(self) -> float:
        return float(self.edges[0])

    def _on(self, t) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Query times as float64 and the edges and powers on their
        device."""
        t = torch.as_tensor(t, dtype=F64)
        return t, self.edges.to(t.device), self.powers.to(t.device)

    def power_at(self, t) -> torch.Tensor:
        """P(t) at every query time, idle outside the covered range."""
        t, e, p = self._on(t)
        if len(p) == 0:
            return torch.full_like(t, self.idle_w)
        idx = torch.searchsorted(e, t.contiguous(), right=True) - 1
        inside = (idx >= 0) & (idx < len(p)) & (t < e[-1])
        return torch.where(inside, p[torch.clamp(idx, 0, len(p) - 1)],
                           self.idle_w)

    def integral(self, t0, t1) -> torch.Tensor:
        """Exact ∫P dt over [t0, t1] (elementwise), idle outside
        coverage: the reference's cumulative-energy formula."""
        t1, e, p = self._on(t1)
        t0 = torch.as_tensor(t0, dtype=F64, device=t1.device)
        cum = torch.cat([torch.zeros(1, dtype=F64, device=e.device),
                         torch.cumsum(p * torch.diff(e), 0)])

        def eval_i(t):
            tc = torch.clamp(t, e[0], e[-1])
            idx = torch.clamp(torch.searchsorted(e, tc.contiguous(),
                                                 right=True) - 1,
                              0, len(p) - 1)
            inner = cum[idx] + p[idx] * (tc - e[idx])
            before = torch.clamp_max(t - e[0], 0.0) * self.idle_w
            after = torch.clamp_min(t - e[-1], 0.0) * self.idle_w
            return inner + before + after

        return eval_i(t1) - eval_i(t0)

    def mean_power(self, t0, t1) -> torch.Tensor:
        t0 = torch.as_tensor(t0, dtype=F64)
        t1 = torch.as_tensor(t1, dtype=F64, device=t0.device)
        return self.integral(t0, t1) / torch.clamp_min(t1 - t0, 1e-12)

    def energy(self, t0: Optional[float] = None,
               t1: Optional[float] = None) -> float:
        """Analytic ground-truth energy in joules over [t0, t1] (default:
        the covered range)."""
        return float(self.integral(self.t_start if t0 is None else t0,
                                   self.t_end if t1 is None else t1))

    def shift(self, dt: float) -> "ActivityTimeline":
        return ActivityTimeline(self.edges + dt, self.powers, self.idle_w)

    def with_idle(self, idle_w: float) -> "ActivityTimeline":
        return ActivityTimeline(self.edges, self.powers, idle_w)

    @staticmethod
    def concat(parts: Sequence["ActivityTimeline"], gap_s: float = 0.0,
               idle_w: Optional[float] = None) -> "ActivityTimeline":
        """Concatenate fragments back-to-back (each re-based to follow the
        previous one), inserting ``gap_s`` of idle power (``idle_w``,
        default the first part's) between them; the reference's cursor
        arithmetic, step for step."""
        if not parts:
            raise ValueError("no parts")
        idle = parts[0].idle_w if idle_w is None else idle_w
        edges: List[float] = []
        powers: List[float] = []
        cursor = parts[0].t_start
        for i, p in enumerate(parts):
            dur = p.t_end - p.t_start
            if i > 0 and gap_s > 0:
                edges.append(cursor)
                powers.append(idle)
                cursor += gap_s
            edges.extend((p.edges + (cursor - p.t_start))[:-1].tolist())
            powers.extend(p.powers.tolist())
            cursor += dur
        edges.append(cursor)
        return ActivityTimeline(torch.tensor(edges, dtype=F64),
                                torch.tensor(powers, dtype=F64), idle)

    def repeat(self, n: int, gap_s: float = 0.0) -> "ActivityTimeline":
        return ActivityTimeline.concat([self] * n, gap_s=gap_s)


def from_segments(segments: Iterable[Tuple[float, float]],
                  t0: float = 0.0, idle_w: float = 60.0) -> ActivityTimeline:
    """Build a timeline from (duration_s, power_w) segments starting at t0."""
    edges = [t0]
    powers = []
    for dur, watts in segments:
        if dur < 0:
            raise ValueError("negative segment duration")
        powers.append(watts)
        edges.append(edges[-1] + dur)
    return ActivityTimeline(torch.tensor(edges, dtype=F64),
                            torch.tensor(powers, dtype=F64), idle_w)


@dataclasses.dataclass(frozen=True)
class TimelineBank:
    """N piecewise-constant power traces as stacked, padded tensors on one
    device: ``edges`` [N, S+1] (non-decreasing per row), ``powers``
    [N, S], ``idle_w`` and ``n_segs`` [N].  Row ``i`` uses its first
    ``n_segs[i]`` segments; padding repeats the row's final edge and holds
    ``idle_w[i]`` (normalised on construction)."""

    edges: torch.Tensor
    powers: torch.Tensor
    idle_w: torch.Tensor
    n_segs: torch.Tensor

    def __post_init__(self):
        e = torch.as_tensor(self.edges, dtype=F64).clone()
        p = torch.as_tensor(self.powers, dtype=F64, device=e.device).clone()
        idle = torch.as_tensor(self.idle_w, dtype=F64, device=e.device)
        ns = torch.as_tensor(self.n_segs, dtype=torch.int64, device=e.device)
        if e.ndim != 2 or p.ndim != 2 or e.shape != (p.shape[0],
                                                     p.shape[1] + 1):
            raise ValueError(f"bad bank shapes {tuple(e.shape)} "
                             f"{tuple(p.shape)}")
        n, s = p.shape
        if n == 0:
            raise ValueError("empty TimelineBank (no rows)")
        if idle.shape != (n,) or ns.shape != (n,):
            raise ValueError(f"idle_w/n_segs must be [{n}]")
        with spans.read("audit.timeline"):
            bad_segs = bool(((ns < 1) | (ns > s)).any())
        if bad_segs:
            raise ValueError(f"n_segs must be within [1, {s}] "
                             "(a row needs at least one segment)")
        cols = torch.arange(s + 1, device=e.device)[None, :]
        last = torch.gather(e, 1, ns[:, None])
        e = torch.where(cols > ns[:, None], last, e)
        p = torch.where(cols[:, :s] >= ns[:, None], idle[:, None], p)
        with spans.read("audit.timeline"):
            falling = bool((torch.diff(e, dim=1) < -1e-12).any())
        if falling:
            raise ValueError("edges must be non-decreasing per row")
        object.__setattr__(self, "edges", e)
        object.__setattr__(self, "powers", p)
        object.__setattr__(self, "idle_w", idle)
        object.__setattr__(self, "n_segs", ns)

    # -- construction / views ---------------------------------------------
    @staticmethod
    def from_timelines(timelines: Sequence[ActivityTimeline], *,
                       device: DeviceLike = "cuda") -> "TimelineBank":
        """Stack timelines into a bank on ``device``."""
        dev = resolve_device(device)
        tls = list(timelines)
        if not tls:
            raise ValueError("empty TimelineBank (no timelines)")
        s = max(len(t.powers) for t in tls)
        edges = torch.empty((len(tls), s + 1), dtype=F64)
        powers = torch.empty((len(tls), s), dtype=F64)
        for i, t in enumerate(tls):
            k = len(t.powers)
            edges[i, :k + 1] = t.edges
            edges[i, k + 1:] = t.edges[-1]
            powers[i, :k] = t.powers
            powers[i, k:] = t.idle_w
        idle = torch.tensor([t.idle_w for t in tls], dtype=F64)
        ns = torch.tensor([len(t.powers) for t in tls], dtype=torch.int64)
        return TimelineBank(edges.to(dev), powers.to(dev), idle.to(dev),
                            ns.to(dev))

    @staticmethod
    def from_timeline(timeline: ActivityTimeline, n: int,
                      shifts: Optional[torch.Tensor] = None, *,
                      device: DeviceLike = "cuda") -> "TimelineBank":
        """Broadcast one timeline to ``n`` rows on ``device``, row ``i``
        shifted by ``shifts[i]``."""
        dev = resolve_device(device)
        if n < 1:
            raise ValueError("empty TimelineBank (n < 1)")
        s = len(timeline.powers)
        edges = timeline.edges.to(dev)[None, :].repeat(n, 1)
        if shifts is not None:
            edges = edges + torch.as_tensor(shifts, dtype=F64,
                                            device=dev)[:, None]
        return TimelineBank(edges, timeline.powers.to(dev)[None, :].repeat(
                                n, 1),
                            torch.full((n,), timeline.idle_w, dtype=F64,
                                       device=dev),
                            torch.full((n,), max(s, 1), dtype=torch.int64,
                                       device=dev))

    def row(self, i: int) -> ActivityTimeline:
        """Row ``i`` as an :class:`ActivityTimeline` on the CPU (an exact
        round trip of :meth:`from_timelines`)."""
        k = int(self.n_segs[i])
        return ActivityTimeline(self.edges[i, :k + 1].cpu(),
                                self.powers[i, :k].cpu(),
                                float(self.idle_w[i]))

    def rows(self, idx) -> "TimelineBank":
        """A bank over a subset of rows."""
        idx = torch.as_tensor(idx, device=self.edges.device)
        return TimelineBank(self.edges[idx], self.powers[idx],
                            self.idle_w[idx], self.n_segs[idx])

    @property
    def device(self) -> torch.device:
        return self.edges.device

    @property
    def n_rows(self) -> int:
        return self.edges.shape[0]

    @property
    def arrays(self) -> TimelineArrays:
        """The padded tensor view the engine ops take."""
        return TimelineArrays(self.edges, self.powers, self.idle_w,
                              self.n_segs)

    @property
    def t_start(self) -> torch.Tensor:
        return self.edges[:, 0]

    @property
    def t_end(self) -> torch.Tensor:
        return self.edges[:, -1]

    @property
    def duration_s(self) -> torch.Tensor:
        return self.t_end - self.t_start

    def shift(self, dt) -> "TimelineBank":
        """Shift every row by ``dt`` (scalar) or row ``i`` by ``dt[i]``."""
        dt = torch.as_tensor(dt, dtype=F64, device=self.device)
        if dt.ndim == 1:
            dt = dt[:, None]
        return TimelineBank(self.edges + dt, self.powers, self.idle_w,
                            self.n_segs)

    # -- queries ----------------------------------------------------------
    def _prep(self, t) -> Tuple[torch.Tensor, tuple]:
        """Normalise a query to [G, M]; returns (queries, output shape)."""
        t = torch.as_tensor(t, dtype=F64, device=self.device)
        if t.ndim == 0:
            return t.expand(self.n_rows, 1), (self.n_rows,)
        if t.ndim == 1:
            if self.n_rows == 1:
                return t[None, :], tuple(t.shape)
            if t.shape[0] == self.n_rows:
                return t[:, None], (self.n_rows,)
            raise ValueError(f"1-D query of length {t.shape[0]} for "
                             f"{self.n_rows} rows (pass [N] or [N, M])")
        if t.ndim == 2:
            if t.shape[0] == 1 and self.n_rows > 1:
                t = t.expand(self.n_rows, t.shape[1])
            if t.shape[0] == self.n_rows or self.n_rows == 1:
                return t, tuple(t.shape)
        raise ValueError(f"bad query shape {tuple(t.shape)} for "
                         f"{self.n_rows} rows")

    def integral(self, t0, t1) -> torch.Tensor:
        """Exact per-row ∫P_i dt over [t0_i, t1_i], idle outside coverage
        (same query shapes as the reference ``TimelineBank.integral``)."""
        tq0, sh0 = self._prep(t0)
        tq1, sh1 = self._prep(t1)
        tq0, tq1 = torch.broadcast_tensors(tq0, tq1)
        out_shape = sh1 if len(sh1) >= len(sh0) else sh0
        if self.n_rows not in (1, tq0.shape[0]):
            raise ValueError(f"{tq0.shape[0]} query rows for "
                             f"{self.n_rows} bank rows")
        return timeline_integral(self.arrays, tq0, tq1).reshape(out_shape)

    def power_at(self, t) -> torch.Tensor:
        """P_i(t) per row, the scalar ``power_at`` applied to each row
        (same query shapes as :meth:`integral`)."""
        tq, out_shape = self._prep(t)
        g = tq.shape[0]
        if self.n_rows not in (1, g):
            raise ValueError(f"{g} query rows for {self.n_rows} bank rows")
        p = _expand(self.powers, g)
        idx = searchsorted_rows(self.edges, tq, "right") - 1
        vals = torch.gather(p, 1, torch.clamp(idx, 0, p.shape[1] - 1))
        inside = ((idx >= 0) & (idx < _expand(self.n_segs, g)[:, None])
                  & (tq < _expand(self.edges, g)[:, -1:]))
        out = torch.where(inside, vals, _expand(self.idle_w, g)[:, None])
        return out.reshape(out_shape)

    def mean_power(self, t0, t1) -> torch.Tensor:
        t0 = torch.as_tensor(t0, dtype=F64, device=self.device)
        t1 = torch.as_tensor(t1, dtype=F64, device=self.device)
        return self.integral(t0, t1) / torch.clamp_min(t1 - t0, 1e-12)

    def energy(self, t0=None, t1=None) -> torch.Tensor:
        """Analytic per-row ground-truth energy [N] in joules over
        [t0_i, t1_i] (default: each row's covered range)."""
        return self.integral(self.t_start if t0 is None else t0,
                             self.t_end if t1 is None else t1)


def _expand(x: torch.Tensor, g: int) -> torch.Tensor:
    return x if x.shape[0] == g else x.expand(g, *x.shape[1:])


def _adc_noise(keys: torch.Tensor, m: int) -> torch.Tensor:
    """Standard normal ADC noise [G, m]: row ``g`` is the keyed stream of
    key ``keys[g]`` (a meter's seed) at samples ``0 .. m-1``."""
    samples = torch.arange(m, device=keys.device)[None, :]
    keyed_rng.check_index("sample", m - 1)
    return keyed_rng.normal(keys[:, None], torch.zeros_like(samples),
                            samples, keyed_rng.TAG_ADC)


def _trapezoid_rows(w: torch.Tensor, ts: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """``np.trapezoid`` of each row's first ``counts[g]`` samples [G]."""
    d = torch.diff(ts, dim=1)
    terms = d * (w[:, 1:] + w[:, :-1]) / 2.0
    keep = (torch.arange(d.shape[1], device=ts.device)[None, :]
            < (counts - 1)[:, None])
    return torch.where(keep, terms, 0.0).sum(dim=1)


class MeterConfig(Config):
    pass


@dataclasses.dataclass(frozen=True)
class GroundTruthMeter:
    """PMD analogue: finite-rate, quantised, noisy sampling of the truth.

    Quantisation mirrors the PMD hardware: 12-bit ADC, 0–31 V
    (7.568 mV/level) and 0–200 A (48.8 mA/level) at a 12 V rail.  The ADC
    noise of sample ``j`` is the keyed stream's draw ``j`` under key
    ``seed``; traces are sampled on ``device``.
    """

    sample_hz: float = 5000.0
    volt_per_level: float = 0.007568
    amp_per_level: float = 0.0488
    rail_volts: float = 12.0
    noise_w: float = 0.3
    seed: int = 0
    device: DeviceLike = "cuda"

    def _quantised(self, p: torch.Tensor) -> torch.Tensor:
        """The ADC's reading of true power ``p``: volts near exact, amps
        coarse."""
        volts = (round(self.rail_volts / self.volt_per_level)
                 * self.volt_per_level)
        amps = p / self.rail_volts
        amps = torch.round(amps / self.amp_per_level) * self.amp_per_level
        return volts * amps

    def trace(self, timeline: ActivityTimeline, t0: Optional[float] = None,
              t1: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sampled ``(times, watts)`` like the PMD raw logger, on the
        meter's device."""
        dev = resolve_device(self.device)
        t0 = timeline.t_start if t0 is None else float(t0)
        t1 = timeline.t_end if t1 is None else float(t1)
        n = max(2, int(round((t1 - t0) * self.sample_hz)))
        ts = t0 + torch.arange(n, dtype=F64, device=dev) / self.sample_hz
        z = _adc_noise(torch.tensor([self.seed], device=dev), n)[0]
        return ts, self._quantised(timeline.power_at(ts)) + self.noise_w * z

    def energy(self, timeline: ActivityTimeline, t0: Optional[float] = None,
               t1: Optional[float] = None) -> float:
        """Energy integrated from the sampled trace (what the paper's PMD
        reports); close to but not exactly the analytic truth."""
        ts, watts = self.trace(timeline, t0, t1)
        n = torch.tensor([ts.shape[0]], device=ts.device)
        return float(_trapezoid_rows(watts[None, :], ts[None, :], n)[0])

    def energy_batch(self, bank: TimelineBank, t0=None, t1=None,
                     chunk_rows: Optional[int] = None) -> torch.Tensor:
        """Per-row PMD energies [N] for a whole :class:`TimelineBank`, on
        its device.  Row ``i`` samples as a meter of seed ``seed + i``
        would, so it equals ``GroundTruthMeter(seed=seed + i).energy(
        bank.row(i))`` up to the order of the trapezoid's sum.  Rows go in
        slabs of ``chunk_rows`` (default: ~16M samples each)."""
        n = bank.n_rows
        dev = bank.device
        t0 = bank.t_start if t0 is None else torch.as_tensor(
            t0, dtype=F64, device=dev).expand(n)
        t1 = bank.t_end if t1 is None else torch.as_tensor(
            t1, dtype=F64, device=dev).expand(n)
        counts = torch.clamp_min(torch.round((t1 - t0) * self.sample_hz)
                                 .to(torch.int64), 2)
        m = int(counts.max())
        if chunk_rows is None:
            chunk_rows = max(1, 16_000_000 // max(m, 1))
        out = torch.empty(n, dtype=F64, device=dev)
        cols = torch.arange(m, dtype=F64, device=dev)[None, :]
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            ts = t0[lo:hi, None] + cols / self.sample_hz
            rows = torch.arange(lo, hi, device=dev)
            watts = self._quantised(bank.rows(rows).power_at(ts))
            watts = watts + self.noise_w * _adc_noise(self.seed + rows, m)
            out[lo:hi] = _trapezoid_rows(watts, ts, counts[lo:hi])
        return out
