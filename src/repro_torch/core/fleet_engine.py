"""Batched fleet sensor simulation, the Monte-Carlo fleet audit and
mergeable moments.

The counterpart of :mod:`repro.core.fleet_engine`:

* :class:`SensorBank` — N on-board sensors as stacked tensors on one
  device, every transient of the paper's Fig. 14: the boxcar window
  (A100/H100 25 ms of every 100 ms, Volta/Pascal 10 of 20 ms), the
  Kepler/Maxwell capacitor-charging filter (the CUDA ``log_filter``
  kernel) and the Fermi model estimate.  It attaches to a shared timeline
  (optionally shifted per device) or a
  :class:`~repro_torch.core.ground_truth.TimelineBank`, answers
  ``query``, emits poll slabs for the monitor (``iter_poll_slabs``) and
  integrates polled series in closed form (``integrate_polled``).
* :func:`fleet_audit` — the naive and §5 protocols over a whole fleet,
  chunked into device slabs, with the error distribution and its
  streamed moments (:class:`FleetAuditResult`).
* :class:`StreamingMoments` — the Chan-merge moment accumulator.

The hidden parameters are drawn once per fleet from a
:class:`torch.Generator` on the CPU.  The reading noise and the poll
jitter come from the keyed stream
(:mod:`repro_torch.engine_backend.keyed_rng`) on the bank's device, keyed
by the bank's seed and addressed by (fleet row, slot): a device reads the
same whatever slab or profile group it is measured in, and on the card as
on the CPU.  None of these are the reference's per-device PCG64 streams:
to compare against the reference, carry its hidden parameters across
with :func:`repro_torch.convert.sensor_bank` and substitute its draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import math
import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.common import spans
from repro_torch.core import profiles as _profiles
from repro_torch.core.calibrate import nominal_record
from repro_torch.core.ground_truth import ActivityTimeline, TimelineBank
from repro_torch.core.load import FleetScenarioSpec, multi_phase_workload
from repro_torch.core.meter import (GoodPracticeConfig, Workload,
                                    as_workload_set,
                                    measure_good_practice_batch,
                                    measure_naive_batch)
from repro_torch.core.sensor import (SensorProfile, SensorUnsupported,
                                     _sum_timelines)
from repro_torch.core.telemetry import SHUNT_TOLERANCE
from repro_torch.engine_backend import keyed_rng
from repro_torch.engine_backend import torch_backend as _tb
from repro_torch.engine_backend.pytrees import PollGrid, ReadingSchedule
from repro_torch.kernels.log_filter import log_filter

F64 = torch.float64
_TRANSIENTS = ("boxcar", "logarithmic", "estimation")


def auto_chunk_devices(n_devices: int, per_device_elems: int,
                       budget_elems: int = 16_000_000) -> int:
    """Device-slab size keeping one slab's intermediates near
    ``budget_elems`` elements (the reference's rule; ``iter_poll_slabs``
    passes a 4M budget): at least 1, at most ``n_devices`` when
    positive."""
    per = max(int(per_device_elems), 1)
    chunk = max(1, int(budget_elems) // per)
    if n_devices > 0:
        chunk = min(chunk, int(n_devices))
    return chunk


def _as_tensor(x, n: int, device: torch.device) -> torch.Tensor:
    """A scalar or [n] value as an [n] float64 tensor on ``device``."""
    on_card = isinstance(x, torch.Tensor) and x.device == device
    with spans.read("audit.upload", 0 if on_card else 1):
        t = torch.as_tensor(x, dtype=F64, device=device)
    if t.ndim == 0:
        return t.expand(n)
    if t.shape != (n,):
        raise ValueError(f"expected scalar or shape ({n},), got "
                         f"{tuple(t.shape)}")
    return t


class SensorBank:
    """N heterogeneous sensors as stacked tensors on ``device``.

    Usage::

        bank = SensorBank.from_catalog(["a100"] * 5000 + ["kepler"] * 5000)
        bank.attach(timeline, shifts=offsets)
        joules = bank.integrate_polled(0.0, 10.0, 0.001, a, b)

    Profile fields, hidden gain, offset, phase and (for estimation rows)
    model gain are per-device tensors on ``device``; the transient kind,
    scope and support are host arrays.  The hidden parameters are drawn
    once, on the CPU, from a :class:`torch.Generator` seeded by ``seed``;
    :meth:`subset` slices them, never re-draws them.  ``host_timeline`` is
    the host draw that module-scope sensors (GH200 ``instant``) add to
    their readings.
    """

    _ROW_FIELDS = ("update_period_s", "window_s", "tau_s", "quantum_w",
                   "noise_w", "sampled_fraction", "transient",
                   "module_scope", "supported", "_rows", "_gain",
                   "_offset", "_phase", "_model_gain")

    def __init__(self, profile_list: Sequence[SensorProfile], *,
                 seed: int = 0,
                 host_timeline: Optional[ActivityTimeline] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.host_timeline = host_timeline
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
            if p.transient not in _TRANSIENTS:
                raise ValueError(f"unknown transient '{p.transient}'")
        code_t = torch.tensor(codes, dtype=torch.int64)
        code_np = np.asarray(codes)

        def table(fn) -> torch.Tensor:
            """A per-device CPU tensor from a per-profile field."""
            return torch.tensor([float(fn(p)) for p in by_code],
                                dtype=F64)[code_t]

        def host(fn, dtype) -> np.ndarray:
            return np.array([fn(p) for p in by_code], dtype=dtype)[code_np]

        period = table(lambda p: p.update_period_s)
        with spans.read("audit.bank", 6):
            self.update_period_s = period.to(self.device)
            self.window_s = table(
                lambda p: p.window_s if p.window_s is not None
                else p.update_period_s).to(self.device)
            self.tau_s = table(lambda p: p.tau_s).to(self.device)
            self.quantum_w = table(lambda p: p.quantum_w).to(self.device)
            self.noise_w = table(lambda p: p.noise_w).to(self.device)
            self.sampled_fraction = table(
                lambda p: p.sampled_fraction).to(self.device)
        self.transient = host(lambda p: p.transient, object)
        self.module_scope = host(lambda p: p.scope == "module", bool)
        self.supported = host(lambda p: p.supported, bool)
        self._rows = np.arange(n)

        # hidden per-device truth, drawn on the CPU
        gen = torch.Generator().manual_seed(self.seed)
        u = torch.rand((3, n), generator=gen, dtype=F64)
        u_model = torch.rand(n, generator=gen, dtype=F64)
        est = torch.as_tensor(self.transient == "estimation")
        hidden = (
            1.0 + (2.0 * u[0] - 1.0) * table(lambda p: p.gain_tol),
            (2.0 * u[1] - 1.0) * table(lambda p: p.offset_tol_w),
            u[2] * period,
            torch.where(est, 1.0 + (2.0 * u_model - 1.0)
                        * table(lambda p: p.model_error), 1.0))
        with spans.read("audit.bank", 4):
            self._gain, self._offset, self._phase, self._model_gain = (
                x.to(self.device) for x in hidden)

        self._ticks: Optional[torch.Tensor] = None    # [N, M] padded
        self._values: Optional[torch.Tensor] = None   # [N, M] padded
        self._first: Optional[torch.Tensor] = None    # [N] first valid slot
        self._last: Optional[torch.Tensor] = None     # [N] last valid slot
        self._k0: Optional[torch.Tensor] = None       # [N] k of slot 0

    @classmethod
    def from_catalog(cls, names: Union[str, Sequence[str]],
                     n: Optional[int] = None, *, seed: int = 0,
                     host_timeline: Optional[ActivityTimeline] = None,
                     device: DeviceLike = "cuda") -> "SensorBank":
        """Build a bank from catalog names: one name with ``n`` copies, or
        an explicit per-device list."""
        if isinstance(names, str):
            names = [names] * (n if n is not None else 1)
        elif n is not None and len(names) != n:
            raise ValueError(f"len(names)={len(names)} != n={n}")
        return cls([_profiles.get(name) for name in names], seed=seed,
                   host_timeline=host_timeline, device=device)

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

    def scalar_reference(self, i: int):
        """The scalar sensor of row ``i``: an
        :class:`~repro_torch.core.sensor.OnboardSensor` over
        ``subset([i])``, whose readings equal this bank's row ``i``
        bitwise."""
        from repro_torch.core.sensor import OnboardSensor
        return OnboardSensor.of_bank(self.subset([i]))

    def _set_hidden(self, gain: torch.Tensor, offset: torch.Tensor,
                    phase: torch.Tensor,
                    model_gain: Optional[torch.Tensor] = None) -> None:
        """Replace the hidden parameters (see :mod:`repro_torch.convert`)
        and drop any attached schedule."""
        n = self.n_devices
        vals = []
        named = (("gain", gain), ("offset", offset), ("phase", phase),
                 ("model_gain", self._model_gain if model_gain is None
                  else model_gain))
        for name, x in named:
            x = torch.as_tensor(x, dtype=F64, device=self.device)
            if x.shape != (n,):
                raise ValueError(f"hidden {name} must be [{n}], "
                                 f"got {tuple(x.shape)}")
            vals.append(x.clone())
        self._gain, self._offset, self._phase, self._model_gain = vals
        self._ticks = self._values = None
        self._first = self._last = self._k0 = None

    def subset(self, idx) -> "SensorBank":
        """A bank over devices ``idx`` of this one: every per-device field
        and hidden parameter is sliced, not re-drawn."""
        idx = np.asarray(torch.as_tensor(idx).cpu(), dtype=np.int64)
        with spans.read("audit.subset"):
            ti = torch.as_tensor(idx, device=self.device)
        nb = object.__new__(SensorBank)
        nb.device = self.device
        nb.seed = self.seed
        nb.host_timeline = self.host_timeline
        nb.profiles = [self.profiles[i] for i in idx]
        for f in self._ROW_FIELDS:
            x = getattr(self, f)
            setattr(nb, f, x[ti] if isinstance(x, torch.Tensor) else x[idx])
        nb._ticks = nb._values = nb._first = nb._last = nb._k0 = None
        return nb

    # -- simulation -------------------------------------------------------
    def attach(self, timeline: Union[ActivityTimeline, TimelineBank],
               t_end: Union[None, float, torch.Tensor] = None,
               t_start: float = 0.0,
               shifts: Optional[torch.Tensor] = None) -> None:
        """Precompute every device's published-reading schedule.

        ``timeline`` is one shared :class:`ActivityTimeline` (device
        ``i`` sees it shifted by ``shifts[i]``) or a :class:`TimelineBank`
        with one row per device.  ``t_end`` may be per-device.  Each
        transient kind runs over its own rows: boxcar means over the
        trailing window, the estimation transient's period mean times the
        model gain, and the logarithmic filter through the ``log_filter``
        kernel with per-row ``tau_s`` (a shared timeline goes in as one
        row).
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
            if (shifts is not None and self.host_timeline is not None
                    and self.module_scope.any()):
                raise NotImplementedError(
                    "per-device shifts with a module-scope host timeline")
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
        with spans.read("audit.ticks"):
            m = int((k1 - k0).max()) + 1
        ks = k0[:, None] + torch.arange(m, device=dev)[None, :]
        ticks = self._phase[:, None] + T[:, None] * ks
        valid = (ks <= k1[:, None]) & (ticks >= t_start - T[:, None])
        first = valid.to(torch.int8).argmax(dim=1)
        count = valid.sum(dim=1)
        with spans.read("audit.ticks"):
            silent = bool((count <= 0).any())
        if silent:
            raise ValueError("a device published no readings in the window")
        last = first + count - 1

        # module-scope rows read the chip's timeline plus the host's;
        # sources: (timeline bank, its rows' device rows or None, devices)
        if self.host_timeline is not None and self.module_scope.any():
            mod_rows = np.nonzero(self.module_scope)[0]
            summed = ([_sum_timelines(bank.row(int(i)), self.host_timeline)
                       for i in mod_rows] if per_device
                      else [_sum_timelines(timeline, self.host_timeline)])
            sources = [(bank, None, ~self.module_scope),
                       (TimelineBank.from_timelines(summed, device=dev),
                        mod_rows if per_device else None, self.module_scope)]
        else:
            sources = [(bank, None, np.ones(n, dtype=bool))]

        raw = torch.zeros_like(ticks)
        for kind in _TRANSIENTS:
            for src, remap, sel in sources:
                rows = np.nonzero((self.transient == kind) & sel)[0]
                if len(rows) == 0:
                    continue
                with spans.read("audit.upload"):
                    rr = torch.as_tensor(rows, device=dev)
                if src.n_rows == 1:
                    tl = src.arrays
                elif remap is not None:
                    tl = src.rows(torch.as_tensor(
                        np.searchsorted(remap, rows), device=dev)).arrays
                else:
                    tl = src.rows(rr).arrays
                t_eval = ticks[rr] - s[rr, None]
                if kind == "boxcar":
                    raw[rr] = _tb.boxcar_means(
                        tl, t_eval - self.window_s[rr, None], t_eval)
                elif kind == "estimation":
                    raw[rr] = _tb.estimation_means(
                        tl, t_eval - T[rr, None], t_eval,
                        self._model_gain[rr])
                else:
                    raw[rr] = log_filter(tl, t_eval, self.tau_s[rr])

        q = self.quantum_w[:, None]
        vals = self._gain[:, None] * raw + self._offset[:, None]
        vals = vals + self._noise(m, first, count)
        vals = torch.clamp_min(torch.round(vals / q) * q, 0.0)
        vals = torch.where(valid, vals, 0.0)

        self._ticks, self._values = ticks, vals
        self._first, self._last, self._k0 = first, last, k0

    def _row_keys(self) -> torch.Tensor:
        """Each device's fleet row [N, 1] on the bank's device: the row
        word of its keyed-stream counters."""
        keyed_rng.check_index("fleet row", int(self._rows.max()))
        with spans.read("audit.upload"):
            return torch.as_tensor(self._rows, dtype=torch.int64,
                                   device=self.device)[:, None]

    def _noise(self, m: int, first: torch.Tensor,
               count: torch.Tensor) -> torch.Tensor:
        """Reading jitter [N, m], aligned to each device's valid slots as
        the reference's is (slot ``first_i + c`` gets row ``i``'s draw
        ``c``; zero outside).

        Draw ``c`` of device ``i`` is the keyed stream's normal at counter
        (fleet row ``_rows[i]``, ``c``) under the bank's seed, made on the
        bank's device: it depends on neither the slab nor the profile
        group the device is measured in, and every attach draws the same
        numbers, as the reference's per-device ``default_rng(seed + 1)``
        does."""
        keyed_rng.check_index("slot", m)
        slot = torch.arange(m, device=self.device)[None, :] - first[:, None]
        valid = (slot >= 0) & (slot < count[:, None])
        z = keyed_rng.normal(self.seed, self._row_keys(),
                             torch.clamp_min(slot, 0), keyed_rng.TAG_NOISE)
        return torch.where(valid, z * self.noise_w[:, None], 0.0)

    # -- query API --------------------------------------------------------
    @property
    def _schedule(self) -> ReadingSchedule:
        if self._ticks is None:
            raise RuntimeError("bank not attached to a timeline")
        return ReadingSchedule(self._ticks, self._first, self._last,
                               self._k0, self._phase, self.update_period_s)

    def _schedule_rows(self, lo: int, hi: int) -> ReadingSchedule:
        return ReadingSchedule(*(x[lo:hi] for x in self._schedule))

    def query(self, t, chunk_devices: Union[int, str, None] = None
              ) -> torch.Tensor:
        """Latest published reading per device at time(s) ``t``: a scalar
        (returns [N]), a shared [K] grid or per-device times [N, K]
        (returns [N, K]).  ``chunk_devices`` bounds the slot-index
        intermediates to device slabs (``"auto"``:
        :func:`auto_chunk_devices`); the values do not depend on it."""
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
        if chunk_devices == "auto":
            chunk_devices = auto_chunk_devices(self.n_devices, tq.shape[1])
        if chunk_devices is None or chunk_devices >= self.n_devices:
            out = torch.gather(self._values, 1, _tb.query_slots(sched, tq))
        else:
            out = torch.empty(tq.shape, dtype=F64, device=self.device)
            for lo in range(0, self.n_devices, chunk_devices):
                hi = min(lo + chunk_devices, self.n_devices)
                j = _tb.query_slots(self._schedule_rows(lo, hi), tq[lo:hi])
                out[lo:hi] = torch.gather(self._values[lo:hi], 1, j)
        return out[:, 0] if scalar else out

    def poll(self, t0: float, t1: float, period_s: float = 0.001,
             jitter_s: float = 0.0, chunk_devices: Optional[int] = None):
        """Fleet-wide ``nvidia-smi -lms``: the shared grid of
        ``floor((t1 - t0) / period_s)`` instants from ``t0`` (the count
        computed on the host, as the reference does) and the [N, M]
        readings.  With ``jitter_s`` each device's instants are late by
        U[0, jitter_s) draws of the keyed stream (fleet row, poll index),
        sorted, and the times are [N, M].  ``chunk_devices`` (default: a
        16M-element budget) slabs the query."""
        n = int(math.floor((t1 - t0) / period_s))
        ts = t0 + period_s * torch.arange(n, dtype=F64, device=self.device)
        if chunk_devices is None:
            chunk_devices = auto_chunk_devices(self.n_devices, n)
        if jitter_s > 0:
            keyed_rng.check_index("poll", n)
            u = keyed_rng.uniform(self.seed, self._row_keys(),
                                  torch.arange(n, device=self.device)[None, :],
                                  keyed_rng.TAG_JITTER)
            ts = torch.sort(ts[None, :] + jitter_s * u, dim=1).values
        return ts, self.query(ts, chunk_devices=chunk_devices)

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
            chunk_devices = auto_chunk_devices(self.n_devices, per_tick,
                                               budget_elems=4_000_000)
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

    def integrate_polled(self, poll_t0: float,
                         poll_t1: Union[float, torch.Tensor],
                         period_s: float,
                         a: Union[float, torch.Tensor],
                         b: Union[float, torch.Tensor],
                         transform=None,
                         grid_offset: Union[float, torch.Tensor] = 0.0
                         ) -> torch.Tensor:
        """Step-integrate each device's polled series over ``[a_i, b_i]``
        [N], without building the [N, n_poll] reading matrix: the poll
        grid from ``poll_t0`` to ``poll_t1`` (per device or shared) at
        ``period_s`` is uniform and the readings are a step function of
        the tick grid, so ``poll_counts`` counts the polls each reading
        covers and the integral is ``period · Σ_k v_k · count_k`` plus the
        final partial step.  ``transform`` maps the [N, M] readings (a
        baseline or calibration correction) first; ``grid_offset`` (per
        device or shared) shifts the reported poll timestamps, the §5
        re-synchronisation."""
        sched = self._schedule
        n = self.n_devices
        dev = self.device
        a = _as_tensor(a, n, dev)
        b = _as_tensor(b, n, dev)
        grid = PollGrid(float(poll_t0), _as_tensor(poll_t1, n, dev),
                        float(period_s), _as_tensor(grid_offset, n, dev))
        counts, slot_b, tail_dt, nonempty = _tb.poll_counts(sched, grid,
                                                            a, b)
        vals = self._values if transform is None else transform(self._values)
        total = (vals * counts).sum(dim=1) * period_s
        # the final poll instant integrates over the partial step
        vb = torch.gather(vals, 1, slot_b[:, None])[:, 0]
        total = total + torch.where(nonempty, vb * tail_dt, 0.0)
        return torch.where(nonempty, total, 0.0)


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

    def update(self, e: torch.Tensor, mesh=None) -> "StreamingMoments":
        """Fold the moments of errors ``e``.  With ``mesh`` (a ``"data"``
        mesh, :func:`repro_torch.launch.mesh.data_mesh`) ``e`` is this
        rank's part: the ranks' blocks are gathered and merged by the
        Chan tree, and every rank folds the whole."""
        if mesh is None:
            return self.merge(*_tb.err_moments(e))
        from repro_torch.core.fleet_engine_shard import mesh_moments
        return self.merge(*mesh_moments(e, mesh))

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


# ---------------------------------------------------------------------------
# Monte-Carlo fleet audit
# ---------------------------------------------------------------------------

def _percentiles(x: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """``np.percentile(x, qs)`` of a 1-D tensor: its default linear
    interpolation, its ``_lerp``, by one sort (``torch.quantile`` refuses
    inputs above 2^24 elements)."""
    s = torch.sort(x).values
    n = s.shape[0]
    out = []
    for q in qs:
        pos = (q / 100) * (n - 1)
        lo = math.floor(pos)
        a, b = s[lo], s[min(lo + 1, n - 1)]
        t = pos - lo
        d = b - a
        out.append(b - d * (1 - t) if t >= 0.5 else a + d * t)
    return torch.stack(out)


def _err_stats(e: torch.Tensor) -> Dict[str, float]:
    """Mean, mean |e|, population std, the 50/90/99th percentiles of |e|
    (linear interpolation, as ``np.percentile``) and the worst |e|."""
    ae = e.abs()
    q = _percentiles(ae, (50, 90, 99))
    vals = torch.stack([e.mean(), ae.mean(), e.std(correction=0), q[0], q[1],
                        q[2], ae.max()]).tolist()
    return dict(zip(("mean_err", "mean_abs_err", "std_err", "p50_abs",
                     "p90_abs", "p99_abs", "worst_abs"), vals))


@dataclasses.dataclass
class FleetAuditResult:
    """Per-device error distribution of a fleet-wide energy audit.

    ``true_j`` is one shared per-repetition truth or an [N] tensor (one
    workload per device); the per-device estimates and errors are [N]
    tensors on the audit's device; ``scenarios`` labels each device's
    workload class (host array) for :meth:`by_scenario`; ``streamed`` holds
    the moments merged slab by slab.
    """

    n_devices: int
    profile_names: List[str]
    true_j: Union[float, torch.Tensor]
    naive_j: torch.Tensor
    naive_err: torch.Tensor
    gp_j: Optional[torch.Tensor] = None
    gp_err: Optional[torch.Tensor] = None
    scenarios: Optional[np.ndarray] = None
    chunk_devices: Optional[int] = None
    streamed: Optional[Dict[str, Dict]] = None

    def stats(self, errs: Optional[torch.Tensor] = None) -> Dict[str, float]:
        return _err_stats(self.naive_err if errs is None else errs)

    def by_scenario(self, errs: Optional[torch.Tensor] = None
                    ) -> Dict[str, Dict[str, float]]:
        """Error stats split by workload scenario label."""
        if self.scenarios is None:
            st = self.stats(errs)
            st["n_devices"] = int(self.n_devices)
            return {"all": st}
        e = self.naive_err if errs is None else errs
        out: Dict[str, Dict[str, float]] = {}
        for label in np.unique(self.scenarios):
            sel = e[torch.as_tensor(self.scenarios == label,
                                    device=e.device)]
            st = _err_stats(sel)
            st["n_devices"] = int(sel.shape[0])
            out[str(label)] = st
        return out

    def uncertainty(self) -> Dict[str, float]:
        """1/√N (independent) vs worst-case (correlated lot) fleet bounds."""
        est = self.gp_j if self.gp_j is not None else self.naive_j
        sigma = SHUNT_TOLERANCE * est
        total, ind, worst = torch.stack([
            est.sum(), (sigma ** 2).sum().sqrt(), sigma.sum()]).tolist()
        return {
            "total_j": total,
            "sigma_independent_j": ind,
            "sigma_worstcase_j": worst,
            "sigma_independent_rel": ind / max(total, 1e-12),
            "sigma_worstcase_rel": worst / max(total, 1e-12),
        }


def _fleet_bank(names: Sequence[str], seed: int,
                device: torch.device) -> SensorBank:
    """The audit's whole fleet, hidden parameters drawn once for all N
    devices, so a chunked audit gives each slab the unchunked rows."""
    return SensorBank.from_catalog(list(names), seed=seed, device=device)


def _audit_setup(n_devices: int, profile, workload, good_practice: bool,
                 dev: torch.device):
    """Normalise ``fleet_audit``'s arguments: ``(workload, names, spec,
    ws_full, calibs)`` with the default ``audit_burst``, one profile name
    a device, the :class:`FleetScenarioSpec` (or ``None``), the whole
    :class:`WorkloadSet` (or ``None``) and the §5 nominal records."""
    if workload is None:
        workload = Workload("audit_burst", multi_phase_workload(
            [(0.130, 215.0), (0.070, 165.0)]))
    names = ([profile] * n_devices if isinstance(profile, str)
             else list(profile))
    if len(names) != n_devices:
        raise ValueError(f"{len(names)} profile names for {n_devices} devices")
    spec = workload if isinstance(workload, FleetScenarioSpec) else None
    if spec is not None:
        if spec.n != n_devices:
            raise ValueError(f"FleetScenarioSpec covers {spec.n} devices, "
                             f"audit asked for {n_devices}")
        ws_full = None
    else:
        ws_full = as_workload_set(workload, n_devices, dev)
    calibs = ({name: nominal_record("fleet", _profiles.get(name))
               for name in set(names)} if good_practice else {})
    return workload, names, spec, ws_full, calibs


def _slab_workloads(spec, ws_full, slabs, prefetch: bool,
                    dev: torch.device):
    """Each slab's :class:`WorkloadSet`, in order (``None`` a slab for a
    shared workload): synthesised from ``spec``, or rows of ``ws_full``."""
    if spec is not None:
        yield from spec.iter_workload_sets(slabs, prefetch=prefetch,
                                           device=dev)
        return
    for lo, hi in slabs:
        if ws_full is None:
            yield None
        else:
            yield (ws_full if (lo, hi) == (0, len(ws_full))
                   else ws_full.rows(lo, hi))


def _audit_slab(fleet: SensorBank, lo: int, hi: int, ws, workload, calibs,
                good_practice: bool, n_trials: int):
    """Rows ``lo .. hi-1`` of ``fleet`` measured naively (and with §5):
    ``({"naive_j", "naive_err"[, "true_j"][, "gp_j", "gp_err"]}, labels)``
    as [hi - lo] tensors, ``true_j`` and the host labels only for
    per-device workloads."""
    bank = (fleet if (lo, hi) == (0, fleet.n_devices)
            else fleet.subset(np.arange(lo, hi)))
    wl = workload if ws is None else ws
    baseline = 0.0 if bank.module_scope.any() else None
    naive = measure_naive_batch(bank, wl, host_baseline_w=baseline)
    tr = workload.true_energy_j if ws is None else ws.true_energies_j
    out = {"naive_j": naive, "naive_err": (naive - tr) / tr}
    if ws is not None:
        out["true_j"] = tr
    if good_practice:
        est = measure_good_practice_batch(
            bank, wl, calibs, GoodPracticeConfig(n_trials=n_trials),
            host_baseline_w=baseline, seeds=np.arange(lo, hi))
        out["gp_j"] = est.joules_per_rep
        out["gp_err"] = (est.joules_per_rep - tr) / tr
    return out, (None if ws is None else ws.scenarios)


def _streamed(sm: Dict[str, Dict]) -> Dict[str, Dict]:
    return {key: {"overall": v["overall"].stats(),
                  "by_scenario": {k: s.stats() for k, s in
                                  sorted(v["by_scenario"].items())}}
            for key, v in sm.items()}


def fleet_audit(n_devices: int, profile: Union[str, Sequence[str]] = "a100",
                workload=None, seed: int = 0, good_practice: bool = False,
                n_trials: int = 2, *, chunk_devices: Optional[int] = None,
                mesh=None, prefetch_workloads: bool = False,
                device: DeviceLike = "cuda") -> FleetAuditResult:
    """Monte-Carlo audit: N devices, each with hidden gain, offset, phase
    (and model gain), measured naively and optionally with the §5
    protocol; returns the per-device error distribution.

    ``profile`` is one catalog name or N of them; ``workload`` one shared
    :class:`~repro_torch.core.meter.Workload` (default: the 200 ms
    two-phase ``audit_burst``), N workloads, a
    :class:`~repro_torch.core.meter.WorkloadSet`, or a
    :class:`~repro_torch.core.load.FleetScenarioSpec` of N devices, whose
    slabs are synthesised on ``device`` as the audit reaches them
    (``prefetch_workloads`` synthesises the next on a worker thread, with
    the same result).  ``chunk_devices`` streams the audit over device
    slabs of that size; each slab takes its rows of the fleet's hidden
    parameters (drawn once), and its devices' reading noise and §5 start
    offsets follow from the fleet row and the protocol seed alone
    (:meth:`SensorBank._noise`), so a chunked audit matches the unchunked
    one per device up to the order of float sums.  Error moments merge
    across slabs by :class:`StreamingMoments` (``result.streamed``);
    ``result.stats()`` gives the exact ones.  A fleet with any
    module-scope sensor (GH200 ``instant``) is measured with a zero host
    baseline, debited from module rows only.

    ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh` with a
    ``"data"`` dimension, :func:`repro_torch.launch.mesh.data_mesh`)
    shards the audit over the mesh's processes: every rank calls this
    with the same arguments, audits its part of each ``chunk_devices``
    super-slab (default: the whole fleet) and returns the whole result
    (:func:`repro_torch.core.fleet_engine_shard.fleet_audit_sharded`).
    """
    if mesh is not None:
        from repro_torch.core import fleet_engine_shard
        return fleet_engine_shard.audit_over_mesh(
            n_devices, profile, workload, seed, good_practice, n_trials,
            chunk=n_devices if chunk_devices is None else chunk_devices,
            mesh=mesh, prefetch_workloads=prefetch_workloads, device=device)
    with spans.span("audit.run"):
        return _fleet_audit(n_devices, profile, workload, seed,
                            good_practice, n_trials, chunk_devices,
                            prefetch_workloads, resolve_device(device))


def _fleet_audit(n_devices, profile, workload, seed, good_practice,
                 n_trials, chunk_devices, prefetch_workloads,
                 dev: torch.device) -> FleetAuditResult:
    """:func:`fleet_audit` on one process, in the phases its spans name:
    ``audit.bank`` (arguments and the fleet's sensor bank),
    ``audit.synth_wait`` (a slab's workloads: synthesised inline, or
    waited for from the prefetch worker), ``audit.measure`` (the slab's
    naive and §5 energies) and ``audit.moments`` (the streamed error
    moments)."""
    with spans.span("audit.bank"):
        workload, names, spec, ws_full, calibs = _audit_setup(
            n_devices, profile, workload, good_practice, dev)
        shared = spec is None and ws_full is None

        if chunk_devices is None:
            slabs = [(0, n_devices)]
        else:
            if chunk_devices < 1:
                raise ValueError(f"chunk_devices must be >= 1, "
                                 f"got {chunk_devices}")
            slabs = [(lo, min(lo + chunk_devices, n_devices))
                     for lo in range(0, n_devices, chunk_devices)]

        fleet = _fleet_bank(names, seed, dev)
    keys = ["naive_j", "naive_err"] + ([] if shared else ["true_j"]) + (
        ["gp_j", "gp_err"] if good_practice else [])
    full = {key: torch.empty(n_devices, dtype=F64, device=dev)
            for key in keys}
    scenarios = None if shared else np.empty(n_devices, dtype=object)
    sm: Dict[str, Dict] = {
        "naive": {"overall": StreamingMoments(), "by_scenario": {}}}
    if good_practice:
        sm["good_practice"] = {"overall": StreamingMoments(),
                               "by_scenario": {}}

    def _stream(key: str, err: torch.Tensor, labels) -> None:
        sm[key]["overall"].update(err)
        if labels is None:
            return
        for label in np.unique(labels):
            with spans.read("audit.moments", 2):
                sel = err[torch.as_tensor(labels == label, device=dev)]
            sm[key]["by_scenario"].setdefault(
                str(label), StreamingMoments()).update(sel)

    ws_iter = iter(_slab_workloads(spec, ws_full, slabs, prefetch_workloads,
                                   dev))
    for lo, hi in slabs:
        with spans.span("audit.synth_wait"):
            ws = next(ws_iter)
        with spans.span("audit.measure"):
            out, labels = _audit_slab(fleet, lo, hi, ws, workload, calibs,
                                      good_practice, n_trials)
            for key in keys:
                full[key][lo:hi] = out[key]
        if scenarios is not None:
            scenarios[lo:hi] = labels
        with spans.span("audit.moments"):
            _stream("naive", out["naive_err"], labels)
            if good_practice:
                _stream("good_practice", out["gp_err"], labels)

    return FleetAuditResult(
        n_devices=n_devices, profile_names=names,
        true_j=(workload.true_energy_j if shared else full["true_j"]),
        naive_j=full["naive_j"], naive_err=full["naive_err"],
        gp_j=full.get("gp_j"), gp_err=full.get("gp_err"),
        scenarios=scenarios, chunk_devices=chunk_devices,
        streamed=_streamed(sm))
