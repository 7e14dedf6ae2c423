"""Replay: run a :class:`~repro_torch.core.fleet_engine.SensorBank`
as a live poll-sample stream, with the reference's fault bank.

The counterpart of :mod:`repro.core.stream.replay`.  :func:`replay`
pushes a bank's poll grid into a
:class:`~repro_torch.core.stream.monitor.MonitorService` slab by slab,
optionally through a :class:`FaultInjector`.  :class:`FaultSpec` is the
declarative fault configuration (the transport knobs: shuffle,
duplicate, drop, delay; and the fault domains: clock drift and skew,
collector restarts, corrupt samples, device dropouts).

The injector draws exactly what the reference draws, from the same numpy
generators on the host: its plan from ``default_rng((seed, 101))`` and
slab ``seq``'s decisions from ``default_rng((seed, 202, seq))``, stage by
stage, each draw sized by the samples that survived the stages before
it.  The masks, indices and permutations those draws give are applied to
the slab on the monitor's device, and delayed samples wait there too.
Given the same input slab, the faulted stream and the
:class:`InjectionLog` are bitwise the reference's.  Learning a stage's
survivor count costs one read-back.

``grid=True`` is the clean-stream contract (one shared strictly
increasing time base), so it raises with any active fault; ``grid=None``
takes the grid path exactly when the spec is fault-free.

:func:`stream_fleet` builds the fleet as
:func:`~repro_torch.core.fleet_engine.fleet_audit` does (through
``fleet_engine._fleet_bank``), streams it into a monitor in device slabs,
and with ``compare=True`` computes the offline ``integrate_polled``
energies on the same reading schedules.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import fleet_engine as _fe
from repro_torch.core import profiles as _profiles
from repro_torch.core.fleet_engine import SensorBank
from repro_torch.core.load import FleetScenarioSpec, multi_phase_workload
from repro_torch.core.meter import ModuleScopeError, Workload, as_workload_set
from repro_torch.core.stream.estimators import (StreamCorrections,
                                                default_calibrations)
from repro_torch.core.stream.monitor import MonitorService

F64, I64 = torch.float64, torch.int64
_FRACTIONS = ("dup_fraction", "drop_fraction", "delay_fraction",
              "corrupt_fraction", "dropout_fraction", "dropout_after")
# the reference's substream tags for the plan and slab generators
_PLAN_STREAM = 101
_SLAB_STREAM = 202


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative transport/collector fault configuration (the
    reference's fields, defaults and validation).

    Transport: ``shuffle`` (permute each slab's arrival order),
    ``dup_fraction`` (re-emit), ``drop_fraction`` (remove),
    ``delay_fraction`` (hold back one slab).  Fault domains:
    ``clock_drift``/``clock_skew_s`` (device ``i`` reports
    ``skew_i + (1 + rate_i) · t``, both uniform in ``±`` the bound),
    ``restart_every_s`` (exponentially spaced collector restarts, each
    losing ``restart_blackout_s`` of samples), ``corrupt_fraction``
    (values to NaN/inf, ids out of range, timestamps to NaN) and
    ``dropout_fraction`` (devices that die for good at a uniform instant
    in the last ``1 - dropout_after`` of the span).
    """

    shuffle: bool = False
    dup_fraction: float = 0.0
    drop_fraction: float = 0.0
    delay_fraction: float = 0.0
    clock_drift: float = 0.0
    clock_skew_s: float = 0.0
    restart_every_s: float = 0.0
    restart_blackout_s: float = 0.05
    corrupt_fraction: float = 0.0
    dropout_fraction: float = 0.0
    dropout_after: float = 0.35
    seed: int = 0

    def __post_init__(self):
        for name in _FRACTIONS:
            f = getattr(self, name)
            if not 0.0 <= f <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {f}")
        if not 0.0 <= self.clock_drift < 1.0:
            raise ValueError("clock_drift must be in [0, 1) — a rate "
                             "error of ±100% would reverse time")
        if self.clock_skew_s < 0.0:
            raise ValueError("clock_skew_s must be >= 0")
        if self.restart_every_s < 0.0 or self.restart_blackout_s < 0.0:
            raise ValueError("restart intervals must be >= 0")

    @property
    def any(self) -> bool:
        """Whether any fault is active (False → clean, grid-eligible)."""
        return bool(self.shuffle or self.dup_fraction or self.drop_fraction
                    or self.delay_fraction or self.clock_drift
                    or self.clock_skew_s or self.restart_every_s
                    or self.corrupt_fraction or self.dropout_fraction)

    def counts_zero(self) -> Dict[str, int]:
        """The all-zero injection-count dict (clean replays report it)."""
        return {k: 0 for k in _COUNT_KEYS}


_COUNT_KEYS = ("dropped_out", "blacked_out", "dropped", "corrupt_value",
               "corrupt_id", "corrupt_time", "duplicated", "delayed",
               "shuffled_slabs")


@dataclasses.dataclass
class InjectionLog:
    """Every injection decision: ``counts`` per category, one dict per
    slab in ``slabs`` (seq, samples in and out, per-category counts), and
    the plan as host arrays (``drift_rate``/``skew_s``/``dropout_t`` per
    device, ``+inf`` for survivors, and the collector ``restarts``).
    With the spec it reproduces the faulted stream."""

    spec: FaultSpec
    n_devices: int
    t0: float
    t1: float
    drift_rate: np.ndarray          # [N] per-device clock rate error
    skew_s: np.ndarray              # [N] per-device clock offset
    dropout_t: np.ndarray           # [N] death instant, +inf = never
    restarts: np.ndarray            # [R] collector restart instants
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    slabs: list = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        """JSON-able digest (plan extremes + aggregate counts)."""
        dead = np.flatnonzero(np.isfinite(self.dropout_t))
        return {
            "seed": self.spec.seed,
            "n_devices": self.n_devices,
            "span": [self.t0, self.t1],
            "n_slabs": len(self.slabs),
            "counts": dict(self.counts),
            "restarts": [float(r) for r in self.restarts],
            "dropped_out_devices": [int(d) for d in dead],
            "dropout_t": [float(self.dropout_t[d]) for d in dead],
            "max_abs_drift": float(np.max(np.abs(self.drift_rate),
                                          initial=0.0)),
            "max_abs_skew_s": float(np.max(np.abs(self.skew_s),
                                           initial=0.0)),
        }


class FaultInjector:
    """Realise a :class:`FaultSpec` over a slab stream on ``device``.

    The plan is drawn once on the host; slab ``seq``'s decisions come
    from its own generator, so a slab injects the same faults however
    the stream is resumed.  ``apply(seq, dev, ts, vs)`` returns the
    faulted slab as tensors on ``device`` (delayed samples are held there
    and put in front of the next slab); :meth:`flush` hands back what is
    still held once the source is drained.
    """

    def __init__(self, spec: FaultSpec, n_devices: int,
                 t0: float, t1: float, *, device: DeviceLike = "cuda"):
        if n_devices < 1:
            raise ValueError("need at least one device")
        self.spec = spec
        self.n_devices = int(n_devices)
        self.device = resolve_device(device)
        plan = np.random.default_rng((spec.seed, _PLAN_STREAM))
        n = self.n_devices
        drift = (spec.clock_drift * plan.uniform(-1.0, 1.0, n)
                 if spec.clock_drift else np.zeros(n))
        skew = (spec.clock_skew_s * plan.uniform(-1.0, 1.0, n)
                if spec.clock_skew_s else np.zeros(n))
        dropout_t = np.full(n, np.inf)
        if spec.dropout_fraction:
            dead = plan.random(n) < spec.dropout_fraction
            at = plan.uniform(spec.dropout_after, 1.0, n)
            dropout_t[dead] = t0 + at[dead] * (t1 - t0)
        restarts = []
        if spec.restart_every_s:
            t = float(t0)
            while True:
                t += plan.exponential(spec.restart_every_s)
                if t >= t1:
                    break
                restarts.append(t)
        self.log = InjectionLog(
            spec=spec, n_devices=n, t0=float(t0), t1=float(t1),
            drift_rate=drift, skew_s=skew, dropout_t=dropout_t,
            restarts=np.asarray(restarts, dtype=np.float64),
            counts=spec.counts_zero())
        # the plan's per-device arrays, on the slabs' device
        self._drift, self._skew, self._dropout_t = (
            torch.as_tensor(x, dtype=F64, device=self.device)
            for x in (drift, skew, dropout_t))
        self._held = None

    def reset(self) -> None:
        """Drop any held (delayed) samples, e.g. before re-playing the
        stream from the top; the plan and log are kept."""
        self._held = None

    def apply(self, seq: int, dev, ts, vs):
        """Inject slab ``seq``'s faults; returns ``(dev, ts, vs)``."""
        spec = self.spec
        c = self.log.counts
        rng = np.random.default_rng((spec.seed, _SLAB_STREAM, int(seq)))
        d0 = self.device
        dev = torch.as_tensor(dev, device=d0).to(I64).reshape(-1)
        ts = torch.as_tensor(ts, dtype=F64, device=d0).reshape(-1)
        vs = torch.as_tensor(vs, dtype=F64, device=d0).reshape(-1)
        rec = {"seq": int(seq), "in": int(dev.numel())}

        def keep_only(keep, key, counter=None):
            nonlocal dev, ts, vs
            k = int(keep.numel()) - int(keep.sum())
            if k:
                dev, ts, vs = dev[keep], ts[keep], vs[keep]
                c[counter or key] += k
                rec[key] = k

        # device deaths and collector blackouts act on true (collector)
        # time, before the device clock garbles the reported timestamps
        if spec.dropout_fraction and dev.numel():
            keep_only(ts < self._dropout_t[dev], "dropped_out")
        if self.log.restarts.size and dev.numel():
            black = torch.zeros(ts.shape, dtype=torch.bool, device=d0)
            for r in self.log.restarts:
                black |= (ts >= float(r)) & (
                    ts < float(r + spec.restart_blackout_s))
            keep_only(~black, "blacked_out")
        if spec.clock_drift or spec.clock_skew_s:
            # two separate f64 ops, as the reference's expression rounds
            ts = self._skew[dev] + (1.0 + self._drift[dev]) * ts
        if spec.drop_fraction and dev.numel():
            keep_only(torch.as_tensor(rng.random(dev.numel())
                                      >= spec.drop_fraction, device=d0),
                      "dropped")
        if spec.corrupt_fraction and dev.numel():
            hit = np.flatnonzero(rng.random(dev.numel())
                                 < spec.corrupt_fraction)
            if hit.size:
                cat = rng.integers(0, 4, hit.size)

                def at(k):
                    return torch.as_tensor(hit[cat == k], device=d0)
                dev, ts, vs = dev.clone(), ts.clone(), vs.clone()
                vs[at(0)] = float("nan")
                vs[at(1)] = float("inf")
                dev[at(2)] += self.n_devices    # out-of-range id
                ts[at(3)] = float("nan")
                nv = int(np.sum(cat <= 1))
                ni = int(np.sum(cat == 2))
                nt = int(np.sum(cat == 3))
                c["corrupt_value"] += nv
                c["corrupt_id"] += ni
                c["corrupt_time"] += nt
                rec["corrupt"] = nv + ni + nt
        if spec.dup_fraction and dev.numel():
            extra_h = rng.random(dev.numel()) < spec.dup_fraction
            k = int(extra_h.sum())
            if k:
                extra = torch.as_tensor(extra_h, device=d0)
                dev = torch.cat([dev, dev[extra]])
                ts = torch.cat([ts, ts[extra]])
                vs = torch.cat([vs, vs[extra]])
                c["duplicated"] += k
                rec["duplicated"] = k
        if spec.delay_fraction and dev.numel():
            hold_h = rng.random(dev.numel()) < spec.delay_fraction
            hold = torch.as_tensor(hold_h, device=d0)
            new_held = (dev[hold], ts[hold], vs[hold])
            dev, ts, vs = dev[~hold], ts[~hold], vs[~hold]
            k = int(hold_h.sum())
            if k:
                c["delayed"] += k
                rec["delayed"] = k
        else:
            new_held = None
        if self._held is not None:
            dev = torch.cat([self._held[0], dev])
            ts = torch.cat([self._held[1], ts])
            vs = torch.cat([self._held[2], vs])
        self._held = new_held
        if spec.shuffle and dev.numel():
            perm = torch.as_tensor(rng.permutation(dev.numel()), device=d0)
            dev, ts, vs = dev[perm], ts[perm], vs[perm]
            c["shuffled_slabs"] += 1
        rec["out"] = int(dev.numel())
        self.log.slabs.append(rec)
        return dev, ts, vs

    def flush(self):
        """Hand back any still-held delayed samples (possibly empty)."""
        held = self._held
        self._held = None
        if held is None:
            d0 = self.device
            return (torch.empty(0, dtype=I64, device=d0),
                    torch.empty(0, dtype=F64, device=d0),
                    torch.empty(0, dtype=F64, device=d0))
        return held


def replay(bank: SensorBank, monitor: MonitorService, t0: float, t1: float,
           period_s: float = 0.001, tick_s: float = 0.5,
           chunk_devices: Optional[int] = None, device_base: int = 0, *,
           shuffle: bool = False, dup_fraction: float = 0.0,
           drop_fraction: float = 0.0, delay_fraction: float = 0.0,
           seed: int = 0, faults: Optional[FaultSpec] = None,
           grid: Optional[bool] = None,
           progress: Optional[Callable] = None) -> Dict[str, int]:
    """Stream ``bank``'s poll grid over ``[t0, t1)`` into ``monitor`` slab
    by slab (the reference's signature and result).

    Faults come from ``faults`` or the legacy knobs
    ``shuffle``/``dup_fraction``/``drop_fraction``/``delay_fraction`` +
    ``seed`` (passing both raises).  A clean stream goes through
    ``ingest_grid`` unless ``grid=False``; ``grid=True`` with an active
    fault raises.  The injector runs on the monitor's device; corrupt ids
    need a monitor built with ``strict_ids=False``.
    ``progress(monitor, t_emitted)`` runs after each ingested slab.
    Returns the monitor's counters with the injector's per-category
    counts under ``"injected"`` (all zero for a clean replay).
    """
    if faults is None:
        faults = FaultSpec(shuffle=shuffle, dup_fraction=dup_fraction,
                           drop_fraction=drop_fraction,
                           delay_fraction=delay_fraction, seed=seed)
    elif shuffle or dup_fraction or drop_fraction or delay_fraction:
        raise ValueError("pass either faults= or the legacy fault knobs, "
                         "not both")
    faulty = faults.any
    if grid is None:
        grid = not faulty
    elif grid and faulty:
        raise ValueError(
            "grid replay is only defined for clean streams: the "
            "rectangular fast path assumes one shared strictly-"
            "increasing time base, which active faults "
            f"({faults!r}) violate — use grid=False or drop the faults")
    if grid:
        for dev, ts, vals in bank.iter_poll_slabs(
                t0, t1, period_s=period_s, tick_s=tick_s,
                chunk_devices=chunk_devices, device_base=device_base,
                grid=True):
            if ts.numel():
                monitor.ingest_grid(dev, ts, vals)
                if progress is not None:
                    progress(monitor, float(ts[-1]))
        out = dict(monitor.counters)
        out["injected"] = faults.counts_zero()
        return out
    inj = FaultInjector(faults, monitor.n_devices, t0, t1,
                        device=monitor.device)
    for seq, (dev, ts, vs) in enumerate(bank.iter_poll_slabs(
            t0, t1, period_s=period_s, tick_s=tick_s,
            chunk_devices=chunk_devices, device_base=device_base)):
        dev, ts, vs = inj.apply(seq, dev, ts, vs)
        if dev.numel():
            monitor.ingest(dev, ts, vs)
            if progress is not None:
                fin = ts[torch.isfinite(ts)]
                if fin.numel():
                    progress(monitor, float(fin.max()))
    held = inj.flush()
    if held[0].numel():
        monitor.ingest(*held)
    out = dict(monitor.counters)
    out["injected"] = dict(inj.log.counts)
    return out


@dataclasses.dataclass
class StreamFleetResult:
    """A streamed fleet plus its offline cross-check (see
    :func:`stream_fleet`): [N] tensors on the run's device, as
    :class:`~repro_torch.core.fleet_engine.FleetAuditResult` holds them,
    and ``labels`` as a host array."""

    monitor: MonitorService
    n_devices: int
    labels: np.ndarray                  # [N] workload labels (host)
    durations_s: torch.Tensor           # [N] workload spans
    win_a: torch.Tensor                 # [N] §5 window starts
    win_b: torch.Tensor                 # [N] §5 window ends
    naive_stream_j: torch.Tensor        # [N] streamed window energy, raw
    corrected_stream_j: torch.Tensor    # [N] streamed, calibrated+shifted
    naive_offline_j: Optional[torch.Tensor] = None      # integrate_polled
    corrected_offline_j: Optional[torch.Tensor] = None  # integrate_polled
    n_samples: int = 0


def stream_fleet(n_devices: int,
                 profile: Union[str, Sequence[str]] = "a100",
                 workload=None, seed: int = 0,
                 chunk_devices: Optional[int] = None,
                 period_s: float = 0.001, tick_s: float = 0.5,
                 start_offset_s: float = 0.3,
                 host_baseline_w: Optional[float] = None,
                 compare: bool = False,
                 monitor_kwargs: Optional[dict] = None,
                 progress: Optional[Callable] = None, *,
                 device: DeviceLike = "cuda") -> StreamFleetResult:
    """Monitor a synthetic fleet live, with ``fleet_audit``'s setup.

    The fleet comes from ``fleet_engine._fleet_bank`` (hidden parameters
    drawn once for all N devices; a device slab takes its rows), so its
    readings are those ``fleet_audit(n_devices, profile, workload, seed)``
    measures.  Each device's §5 window ``[start_offset_s, start_offset_s
    + duration]`` is registered, and the poll grid streams through a
    :class:`MonitorService` on ``device`` in slabs of ``chunk_devices``
    devices.  With ``compare=True`` the offline ``integrate_polled``
    energies (raw, and calibrated and re-synchronised) are computed on
    the same schedules.  ``workload`` is one shared
    :class:`~repro_torch.core.meter.Workload` (default: the 200 ms
    two-phase ``audit_burst``), N of them, a
    :class:`~repro_torch.core.meter.WorkloadSet` or a
    :class:`~repro_torch.core.load.FleetScenarioSpec` of N devices,
    whose slabs are synthesised on ``device``: once for the durations
    and labels, and again as each is streamed.
    """
    dev = resolve_device(device)
    if workload is None:
        workload = Workload("audit_burst", multi_phase_workload(
            [(0.130, 215.0), (0.070, 165.0)]))
    names = ([profile] * n_devices if isinstance(profile, str)
             else list(profile))
    if len(names) != n_devices:
        raise ValueError(f"{len(names)} profile names for "
                         f"{n_devices} devices")
    spec = workload if isinstance(workload, FleetScenarioSpec) else None
    if spec is not None and spec.n != n_devices:
        raise ValueError(f"FleetScenarioSpec covers {spec.n} devices, "
                         f"stream asked for {n_devices}")
    ws_full = (None if spec is not None
               else as_workload_set(workload, n_devices, dev))

    if chunk_devices is None:
        slabs = [(0, n_devices)]
    else:
        if chunk_devices < 1:
            raise ValueError(f"chunk_devices must be >= 1, "
                             f"got {chunk_devices}")
        slabs = [(lo, min(lo + chunk_devices, n_devices))
                 for lo in range(0, n_devices, chunk_devices)]

    def slab_ws(lo, hi):
        if spec is not None:
            return spec.workload_set(lo, hi, device=dev)
        if ws_full is None:
            return None
        return ws_full if len(slabs) == 1 else ws_full.rows(lo, hi)

    if spec is not None:
        # pass 1: durations and labels, slab by slab (the banks are
        # synthesised again in the stream pass)
        durations = torch.empty(n_devices, dtype=F64, device=dev)
        labels = np.empty(n_devices, dtype=object)
        for lo, hi in slabs:
            ws = slab_ws(lo, hi)
            durations[lo:hi] = ws.durations_s
            labels[lo:hi] = ws.scenarios
    elif ws_full is None:
        durations = torch.full((n_devices,), workload.duration_s, dtype=F64,
                               device=dev)
        labels = np.full(n_devices, workload.scenario_label, dtype=object)
    else:
        durations = ws_full.durations_s.to(dev)
        labels = np.asarray(ws_full.scenarios, dtype=object)

    module = np.array([_profiles.get(nm).scope == "module" for nm in names])
    if np.any(module) and host_baseline_w is None:
        raise ModuleScopeError(
            "module-scope profiles need host_baseline_w to debit host "
            "power from the stream")
    baseline = torch.as_tensor(np.where(module, host_baseline_w or 0.0, 0.0),
                               dtype=F64, device=dev)
    corr = StreamCorrections.from_calibrations(
        names, default_calibrations(names), baseline_w=baseline, device=dev)
    monitor = MonitorService(n_devices, corrections=corr, labels=labels,
                             device=dev, **(monitor_kwargs or {}))
    win_a = torch.full((n_devices,), float(start_offset_s), dtype=F64,
                       device=dev)
    win_b = start_offset_s + durations
    monitor.set_windows(win_a, win_b)

    naive_off = torch.empty(n_devices, dtype=F64, device=dev) \
        if compare else None
    corr_off = torch.empty_like(naive_off) if compare else None

    fleet = _fe._fleet_bank(names, seed, dev)
    for lo, hi in slabs:
        bank = fleet if len(slabs) == 1 else fleet.subset(np.arange(lo, hi))
        ws = slab_ws(lo, hi)
        if ws is None:
            tl = workload.timeline.shift(start_offset_s
                                         - workload.timeline.t_start)
            bank.attach(tl, t_end=tl.t_end + 1.0)
            grid_t1 = float(tl.t_end + 0.5)
        else:
            tlb = ws.timeline_bank
            tlb = tlb.shift(start_offset_s - tlb.t_start)
            bank.attach(tlb, t_end=tlb.t_end + 1.0)
            grid_t1 = float(tlb.t_end.max() + 0.5)
        replay(bank, monitor, 0.0, grid_t1, period_s=period_s,
               tick_s=tick_s, device_base=lo, progress=progress)

        if compare:
            base_rows = baseline[lo:hi]
            a, b = win_a[lo:hi], win_b[lo:hi]
            naive_off[lo:hi] = bank.integrate_polled(
                0.0, grid_t1, period_s, a, b,
                transform=lambda v, br=base_rows: v - br[:, None])
            # each sensor class re-synchronises by its own window
            gains = corr.gain[lo:hi]
            offs = corr.offset_w[lo:hi]
            corr_off[lo:hi] = bank.integrate_polled(
                0.0, grid_t1, period_s, a, b,
                transform=lambda v, br=base_rows, g=gains, o=offs:
                    ((v - br[:, None]) - o[:, None]) / g[:, None],
                grid_offset=-corr.time_shift_s[lo:hi])

    return StreamFleetResult(
        monitor=monitor, n_devices=n_devices, labels=labels,
        durations_s=durations, win_a=win_a, win_b=win_b,
        naive_stream_j=monitor.window_energy(corrected=False),
        corrected_stream_j=monitor.window_energy(corrected=True),
        naive_offline_j=naive_off, corrected_offline_j=corr_off,
        n_samples=monitor.counters["accepted"])
