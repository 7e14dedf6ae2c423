"""Batched fleet sensor simulation and mergeable moments.

The counterpart of the parts of :mod:`repro.core.fleet_engine` the live
monitor needs:

* :class:`SensorBank` — N on-board sensors as stacked tensors on one
  device, restricted to the boxcar transient: the A100/H100 class whose
  25 ms window per 100 ms period is the paper's headline finding.  It
  attaches to a shared timeline (optionally shifted per device) or a
  :class:`~repro_torch.core.ground_truth.TimelineBank`, answers
  ``query``, and emits poll slabs for the monitor (``iter_poll_slabs``).
  Hidden gain, offset and phase and the reading noise come from explicit
  :class:`torch.Generator`\\ s seeded by ``seed``; they are not the
  reference's per-device PCG64 streams, so to compare against the
  reference, carry its hidden parameters across with
  :func:`repro_torch.convert.sensor_bank`.
* :class:`StreamingMoments` — the Chan-merge moment accumulator.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import math
import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import profiles as _profiles
from repro_torch.core.ground_truth import ActivityTimeline, TimelineBank
from repro_torch.core.sensor import SensorProfile, SensorUnsupported
from repro_torch.engine_backend import torch_backend as _tb
from repro_torch.engine_backend.pytrees import ReadingSchedule

F64 = torch.float64


def auto_chunk_devices(n_devices: int, per_device_elems: int,
                       budget_elems: int = 4_000_000) -> int:
    """Device-slab size keeping one slab near ``budget_elems`` samples
    (the reference's rule for poll slabs): at least 1, at most
    ``n_devices`` when positive."""
    per = max(int(per_device_elems), 1)
    chunk = max(1, int(budget_elems) // per)
    if n_devices > 0:
        chunk = min(chunk, int(n_devices))
    return chunk


class SensorBank:
    """N boxcar sensors as stacked tensors on ``device``.

    Usage::

        bank = SensorBank.from_catalog(["a100"] * 5000, seed=0)
        bank.attach(timeline, shifts=offsets)
        for dev, ts, vals in bank.iter_poll_slabs(0.0, 10.0, grid=True):
            monitor.ingest_grid(dev, ts, vals)
    """

    def __init__(self, profile_list: Sequence[SensorProfile], *,
                 seed: int = 0, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.profiles: List[SensorProfile] = list(profile_list)
        n = len(self.profiles)
        if n == 0:
            raise ValueError("empty sensor bank")
        self.seed = int(seed)
        uniq: Dict[int, int] = {}
        codes = [uniq.setdefault(id(p), len(uniq)) for p in self.profiles]
        by_code: List[SensorProfile] = [None] * len(uniq)
        for p, c in zip(self.profiles, codes):
            by_code[c] = p
        for p in by_code:
            if p.transient == "boxcar":
                continue
            if p.transient in ("logarithmic", "estimation"):
                raise NotImplementedError(
                    f"profile '{p.name}' has a {p.transient} transient; the "
                    "port's SensorBank takes boxcar sensors only so far "
                    "(the log_filter kernel and the estimation transient "
                    "come with the fleet-audit slice)")
            raise ValueError(f"unknown transient '{p.transient}'")
        code_t = torch.tensor(codes, dtype=torch.int64)

        def field(fn) -> torch.Tensor:
            table = torch.tensor([float(fn(p)) for p in by_code], dtype=F64)
            return table[code_t].to(self.device)

        self.update_period_s = field(lambda p: p.update_period_s)
        self.window_s = field(lambda p: p.window_s if p.window_s is not None
                              else p.update_period_s)
        self.quantum_w = field(lambda p: p.quantum_w)
        self.noise_w = field(lambda p: p.noise_w)
        self.supported = np.array([p.supported for p in self.profiles])

        # hidden per-device truth, from an explicit generator
        gain_tol = field(lambda p: p.gain_tol)
        off_tol = field(lambda p: p.offset_tol_w)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        u = torch.rand((3, n), generator=gen, dtype=F64, device=self.device)
        self._gain = 1.0 + (2.0 * u[0] - 1.0) * gain_tol
        self._offset = (2.0 * u[1] - 1.0) * off_tol
        self._phase = u[2] * self.update_period_s

        self._ticks: Optional[torch.Tensor] = None    # [N, M] padded
        self._values: Optional[torch.Tensor] = None   # [N, M] padded
        self._first: Optional[torch.Tensor] = None    # [N] first valid slot
        self._last: Optional[torch.Tensor] = None     # [N] last valid slot
        self._k0: Optional[torch.Tensor] = None       # [N] k of slot 0

    @classmethod
    def from_catalog(cls, names: Union[str, Sequence[str]],
                     n: Optional[int] = None, *, seed: int = 0,
                     device: DeviceLike = "cuda") -> "SensorBank":
        """Build a bank from catalog names: one name with ``n`` copies, or
        an explicit per-device list."""
        if isinstance(names, str):
            names = [names] * (n if n is not None else 1)
        elif n is not None and len(names) != n:
            raise ValueError(f"len(names)={len(names)} != n={n}")
        return cls([_profiles.get(name) for name in names], seed=seed,
                   device=device)

    @property
    def n_devices(self) -> int:
        return len(self.profiles)

    @property
    def true_gain(self) -> torch.Tensor:
        return self._gain

    @property
    def true_offset(self) -> torch.Tensor:
        return self._offset

    @property
    def true_phase(self) -> torch.Tensor:
        return self._phase

    def _set_hidden(self, gain: torch.Tensor, offset: torch.Tensor,
                    phase: torch.Tensor) -> None:
        """Replace the hidden parameters (see :mod:`repro_torch.convert`)
        and drop any attached schedule."""
        n = self.n_devices
        vals = []
        for name, x in (("gain", gain), ("offset", offset),
                        ("phase", phase)):
            x = torch.as_tensor(x, dtype=F64, device=self.device)
            if x.shape != (n,):
                raise ValueError(f"hidden {name} must be [{n}], "
                                 f"got {tuple(x.shape)}")
            vals.append(x.clone())
        self._gain, self._offset, self._phase = vals
        self._ticks = self._values = None
        self._first = self._last = self._k0 = None

    # -- simulation -------------------------------------------------------
    def attach(self, timeline: Union[ActivityTimeline, TimelineBank],
               t_end: Union[None, float, torch.Tensor] = None,
               t_start: float = 0.0,
               shifts: Optional[torch.Tensor] = None) -> None:
        """Precompute every device's published-reading schedule.

        ``timeline`` is one shared :class:`ActivityTimeline` (device
        ``i`` sees it shifted by ``shifts[i]``) or a :class:`TimelineBank`
        with one row per device.  ``t_end`` may be per-device.
        """
        n = self.n_devices
        dev = self.device
        if not self.supported.all():
            bad = self.profiles[int(np.argmin(self.supported))]
            raise SensorUnsupported(f"{bad.name} exposes no power readings")
        per_device = isinstance(timeline, TimelineBank)
        if per_device:
            if timeline.n_rows != n:
                raise ValueError(f"TimelineBank has {timeline.n_rows} rows "
                                 f"for {n} devices")
            if shifts is not None:
                raise ValueError(
                    "per-device shifts are redundant with a TimelineBank; "
                    "bake them in with TimelineBank.shift(offsets)")
            bank = timeline
            s = torch.zeros(n, dtype=F64, device=dev)
        else:
            bank = TimelineBank.from_timelines([timeline], device=dev)
            s = (torch.zeros(n, dtype=F64, device=dev) if shifts is None
                 else torch.as_tensor(shifts, dtype=F64,
                                      device=dev).expand(n).clone())
        if bank.device != dev:
            raise ValueError(f"timeline bank is on {bank.device}, "
                             f"sensor bank on {dev}")

        T = self.update_period_s
        if t_end is None:
            te = (bank.t_end if per_device else timeline.t_end + s) + 2.0 * T
        else:
            te = torch.as_tensor(t_end, dtype=F64, device=dev).expand(n)

        # padded tick grid: the reference's `phase + T*k` expression
        k0 = torch.floor((t_start - self._phase) / T).to(torch.int64)
        k1 = torch.ceil((te - self._phase) / T).to(torch.int64)
        m = int((k1 - k0).max()) + 1
        ks = k0[:, None] + torch.arange(m, device=dev)[None, :]
        ticks = self._phase[:, None] + T[:, None] * ks
        valid = (ks <= k1[:, None]) & (ticks >= t_start - T[:, None])
        first = valid.to(torch.int8).argmax(dim=1)
        count = valid.sum(dim=1)
        if bool((count <= 0).any()):
            raise ValueError("a device published no readings in the window")
        last = first + count - 1

        t_eval = ticks - s[:, None]
        raw = _tb.boxcar_means(bank.arrays, t_eval - self.window_s[:, None],
                               t_eval)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 1)
        noise = torch.randn(ticks.shape, generator=gen, dtype=F64,
                            device=dev) * self.noise_w[:, None]
        q = self.quantum_w[:, None]
        vals = self._gain[:, None] * raw + self._offset[:, None]
        vals = vals + noise
        vals = torch.clamp_min(torch.round(vals / q) * q, 0.0)
        vals = torch.where(valid, vals, 0.0)

        self._ticks, self._values = ticks, vals
        self._first, self._last, self._k0 = first, last, k0

    # -- query API --------------------------------------------------------
    @property
    def _schedule(self) -> ReadingSchedule:
        if self._ticks is None:
            raise RuntimeError("bank not attached to a timeline")
        return ReadingSchedule(self._ticks, self._first, self._last,
                               self._k0, self._phase, self.update_period_s)

    def _schedule_rows(self, lo: int, hi: int) -> ReadingSchedule:
        return ReadingSchedule(*(x[lo:hi] for x in self._schedule))

    def query(self, t) -> torch.Tensor:
        """Latest published reading per device at time(s) ``t``: a scalar
        (returns [N]), a shared [K] grid or per-device times [N, K]
        (returns [N, K])."""
        sched = self._schedule
        t = torch.as_tensor(t, dtype=F64, device=self.device)
        scalar = t.ndim == 0
        if t.ndim <= 1:
            t1 = t.reshape(-1)
            tq = t1[None, :].expand(self.n_devices, t1.shape[0])
        elif t.ndim == 2 and t.shape[0] == self.n_devices:
            tq = t
        else:
            raise ValueError(f"bad query shape {tuple(t.shape)}")
        out = torch.gather(self._values, 1, _tb.query_slots(sched, tq))
        return out[:, 0] if scalar else out

    def iter_poll_slabs(self, t0: float, t1: float,
                        period_s: float = 0.001, tick_s: float = 0.5,
                        chunk_devices: Optional[int] = None,
                        device_base: int = 0, grid: bool = False):
        """Yield raw poll-sample slabs over the uniform poll grid on
        ``[t0, t1)``, cut into wall-clock ticks of ``tick_s`` and, within
        a tick, device chunks of ``chunk_devices`` (default: the
        reference's 4M-sample budget).

        Flattened device-major ``(dev [K], t [K], v [K])`` slabs for
        :meth:`~repro_torch.core.stream.monitor.MonitorService.ingest`,
        or with ``grid=True`` rectangular ``(dev [D], ts [M], v [D, M])``
        slabs for ``ingest_grid``.  Everything is on the bank's device.
        """
        n_polls = int(math.floor((t1 - t0) / period_s))
        per_tick = max(1, int(round(tick_s / period_s)))
        if chunk_devices is None:
            chunk_devices = auto_chunk_devices(self.n_devices, per_tick)
        dev = self.device
        for j_lo in range(0, n_polls, per_tick):
            j_hi = min(j_lo + per_tick, n_polls)
            ts = t0 + period_s * torch.arange(j_lo, j_hi, dtype=F64,
                                              device=dev)
            m = j_hi - j_lo
            for lo in range(0, self.n_devices, chunk_devices):
                hi = min(lo + chunk_devices, self.n_devices)
                tq = ts[None, :].expand(hi - lo, m)
                j = _tb.query_slots(self._schedule_rows(lo, hi), tq)
                vals = torch.gather(self._values[lo:hi], 1, j)
                ids = torch.arange(lo, hi, device=dev) + device_base
                if grid:
                    yield ids, ts, vals
                else:
                    yield (torch.repeat_interleave(ids, m),
                           ts.repeat(hi - lo), vals.reshape(-1))


class StreamingMoments:
    """Mergeable moment accumulator (count, mean, M2, mean |e|, max |e|)
    by Chan's parallel-Welford update; host-side floats."""

    __slots__ = ("n", "mean", "m2", "mean_abs", "max_abs")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.mean_abs = 0.0
        self.max_abs = 0.0

    def update(self, e: torch.Tensor) -> "StreamingMoments":
        return self.merge(*_tb.err_moments(e))

    def merge(self, nb: int, mean_b: float, m2_b: float,
              mean_abs_b: float, max_abs_b: float) -> "StreamingMoments":
        """Fold one pre-reduced moment block."""
        if nb == 0:
            return self
        na = self.n
        tot = na + nb
        delta = mean_b - self.mean
        self.mean += delta * nb / tot
        self.m2 += m2_b + delta * delta * na * nb / tot
        self.mean_abs += (mean_abs_b - self.mean_abs) * nb / tot
        self.max_abs = max(self.max_abs, max_abs_b)
        self.n = tot
        return self

    def stats(self) -> Dict[str, float]:
        if self.n == 0:
            return {"mean_err": 0.0, "mean_abs_err": 0.0, "std_err": 0.0,
                    "worst_abs": 0.0, "n_devices": 0}
        return {
            "mean_err": float(self.mean),
            "mean_abs_err": float(self.mean_abs),
            "std_err": float(math.sqrt(max(self.m2 / self.n, 0.0))),
            "worst_abs": float(self.max_abs),
            "n_devices": int(self.n),
        }
