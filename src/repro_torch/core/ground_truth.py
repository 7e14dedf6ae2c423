"""Ground-truth power: activity timelines and stacked timeline banks.

The counterparts of :class:`repro.core.ground_truth.ActivityTimeline`,
``from_segments`` and the parts of ``TimelineBank`` the monitor's source
needs.  An :class:`ActivityTimeline` is a small description (float64
tensors on the CPU); a :class:`TimelineBank` holds ``N`` padded traces
on a device and answers exact integrals there.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.engine_backend.pytrees import TimelineArrays
from repro_torch.engine_backend.torch_backend import timeline_integral

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

    def shift(self, dt: float) -> "ActivityTimeline":
        return ActivityTimeline(self.edges + dt, self.powers, self.idle_w)


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
        if bool(((ns < 1) | (ns > s)).any()):
            raise ValueError(f"n_segs must be within [1, {s}] "
                             "(a row needs at least one segment)")
        cols = torch.arange(s + 1, device=e.device)[None, :]
        last = torch.gather(e, 1, ns[:, None])
        e = torch.where(cols > ns[:, None], last, e)
        p = torch.where(cols[:, :s] >= ns[:, None], idle[:, None], p)
        if bool((torch.diff(e, dim=1) < -1e-12).any()):
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
    def t_end(self) -> torch.Tensor:
        return self.edges[:, -1]

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
