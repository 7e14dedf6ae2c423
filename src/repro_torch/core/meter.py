"""Energy measurement protocols, batched: naive vs the paper's good
practice (§5), for a whole :class:`~repro_torch.core.fleet_engine.
SensorBank` at once.

The counterpart of the batched half of :mod:`repro.core.meter`:

* naive (what the surveyed literature does): run the workload once,
  integrate the polled readings over the execution window;
* good practice (§5.1): ≥32 repetitions or ≥5 s, with 8 evenly spaced
  one-window delays when the sensor samples part of each period;
  ``n_trials`` trials at random start offsets; the repetitions inside the
  rise time discarded and the readings re-synchronised by the window.

The scalar ``measure_naive``, ``measure_good_practice`` and
``compare_protocols`` run on one :class:`~repro_torch.core.sensor.
OnboardSensor` (a one-device bank): each polls the sensor on its device
and integrates the readings with the ``step_integrate`` kernel
(:mod:`repro_torch.kernels.step_integrate`; its plain version on the
CPU).  The §5 trial start offsets come from the keyed stream under the
protocol seed (:func:`_trial_starts`), so device ``i`` of a batched run
starts where the scalar protocol with seed ``seeds[i]`` does.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.common import spans
from repro_torch.core.calibrate import CalibrationRecord
from repro_torch.core.ground_truth import ActivityTimeline, TimelineBank
from repro_torch.engine_backend import keyed_rng
from repro_torch.kernels.step_integrate import step_integrate

if TYPE_CHECKING:  # banks and sensors are duck-typed below
    from repro_torch.core.fleet_engine import SensorBank
    from repro_torch.core.sensor import OnboardSensor

F64 = torch.float64
I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class Workload:
    """One repetition of a measurable workload; ``scenario`` labels it
    for per-scenario breakdowns (default: its name)."""

    name: str
    timeline: ActivityTimeline        # fragment starting at t=0
    scenario: Optional[str] = None

    def __post_init__(self):
        if self.duration_s <= 0.0:
            raise ValueError(
                f"workload '{self.name}' has zero/negative duration "
                f"({self.duration_s} s); a repetition must cover time")

    @property
    def duration_s(self) -> float:
        return self.timeline.t_end - self.timeline.t_start

    @property
    def true_energy_j(self) -> float:
        """Analytic per-repetition ground truth."""
        return self.timeline.energy()

    @property
    def scenario_label(self) -> str:
        return self.scenario if self.scenario is not None else self.name


class WorkloadSet:
    """Per-device workloads for a heterogeneous fleet: device ``i`` runs
    ``workloads[i]``.  Built from :class:`Workload` objects (stacked once
    into a :class:`TimelineBank` on ``device``) or from a bank directly
    (``bank=``, ``scenarios=``).  ``durations_s`` and ``true_energies_j``
    are [N] tensors on the bank's device; ``scenarios`` is a host array."""

    def __init__(self, workloads: Optional[Sequence[Workload]] = None, *,
                 bank: Optional[TimelineBank] = None,
                 scenarios: Optional[Sequence[str]] = None,
                 device: DeviceLike = "cuda"):
        if (workloads is None) == (bank is None):
            raise ValueError("pass exactly one of workloads= or bank=")
        if bank is None:
            wls = list(workloads)
            if not wls:
                raise ValueError("empty WorkloadSet")
            bank = TimelineBank.from_timelines([w.timeline for w in wls],
                                               device=resolve_device(device))
            scenarios = [w.scenario_label for w in wls]
        elif scenarios is None:
            scenarios = [f"workload[{i}]" for i in range(bank.n_rows)]
        if len(scenarios) != bank.n_rows:
            raise ValueError(f"{len(scenarios)} scenario labels for "
                             f"{bank.n_rows} bank rows")
        self.timeline_bank = bank
        self.durations_s = bank.duration_s
        self.true_energies_j = bank.energy()
        self.scenarios = np.asarray(scenarios, dtype=object)

    def __len__(self) -> int:
        return self.timeline_bank.n_rows

    def rows(self, lo: int, hi: int) -> "WorkloadSet":
        """The device slab ``lo .. hi-1`` as its own set (bank rows are
        sliced, not re-derived)."""
        return WorkloadSet(bank=self.timeline_bank.rows(
                               torch.arange(lo, hi)),
                           scenarios=self.scenarios[lo:hi])


@dataclasses.dataclass(frozen=True)
class GoodPracticeConfig:
    min_reps: int = 32
    min_total_s: float = 5.0
    n_phase_shifts: int = 8
    n_trials: int = 4
    discard_rise: bool = True
    time_shift: bool = True
    apply_calibration: bool = False
    poll_period_s: float = 0.001
    max_reps: int = 4096


@dataclasses.dataclass
class EnergyEstimate:
    joules_per_rep: float
    std_j: float
    n_trials: int
    n_reps: int
    trial_values: List[float]

    def error_vs(self, truth_j: float) -> float:
        return (self.joules_per_rep - truth_j) / truth_j


class ModuleScopeError(RuntimeError):
    """Raised when a module-scope sensor (GH200 `instant`, §6) would be
    attributed to chip-level energy without a host baseline."""


@dataclasses.dataclass
class BatchedEnergyEstimate:
    """Per-device good-practice estimates for a whole fleet."""

    joules_per_rep: torch.Tensor     # [N]
    std_j: torch.Tensor              # [N]
    n_trials: int
    n_reps: torch.Tensor             # [N]
    trial_values: torch.Tensor       # [N, n_trials]

    def error_vs(self, truth_j) -> torch.Tensor:
        return (self.joules_per_rep - truth_j) / truth_j

    def device(self, i: int) -> EnergyEstimate:
        """The scalar view of one device's estimate."""
        return EnergyEstimate(float(self.joules_per_rep[i]),
                              float(self.std_j[i]), self.n_trials,
                              int(self.n_reps[i]),
                              [float(v) for v in self.trial_values[i]])


# ---------------------------------------------------------------------------
# Scalar protocols: one sensor
# ---------------------------------------------------------------------------

def _integrate_readings(ts: torch.Tensor, vals: torch.Tensor, t0: float,
                        t1: float) -> float:
    """Step-integrate one polled reading series over [t0, t1]: a [1, M]
    call of the ``step_integrate`` kernel on the readings' device (its
    plain version on the CPU)."""
    dev = vals.device
    return float(step_integrate(
        ts[None, :], vals[None, :],
        torch.tensor([t0], dtype=F64, device=dev),
        torch.tensor([t1], dtype=F64, device=dev))[0])


def _check_scope(sensor: "OnboardSensor",
                 host_baseline_w: Optional[float]) -> float:
    if sensor.profile.scope == "module" and host_baseline_w is None:
        raise ModuleScopeError(
            f"profile '{sensor.profile.name}' measures the whole module "
            "(GPU+CPU+DRAM); supply host_baseline_w to subtract, or use a "
            "chip-scope profile")
    return host_baseline_w or 0.0


def measure_naive(sensor: "OnboardSensor", workload: Workload,
                  start_offset_s: float = 0.3,
                  host_baseline_w: Optional[float] = None,
                  poll_period_s: float = 0.001) -> float:
    """Single run; integrate sensor power over the execution window
    only."""
    baseline = _check_scope(sensor, host_baseline_w)
    tl = workload.timeline.shift(start_offset_s - workload.timeline.t_start)
    sensor.attach(tl, t_end=tl.t_end + 1.0)
    ts, vals = sensor.poll(0.0, tl.t_end + 0.5, period_s=poll_period_s)
    vals = vals - baseline
    return _integrate_readings(ts, vals, start_offset_s,
                               start_offset_s + workload.duration_s)


def measure_good_practice(sensor: "OnboardSensor", workload: Workload,
                          calib: CalibrationRecord,
                          cfg: GoodPracticeConfig = GoodPracticeConfig(),
                          host_baseline_w: Optional[float] = None,
                          seed: int = 0) -> EnergyEstimate:
    """The paper's protocol; returns a per-repetition energy estimate.
    Trial ``t`` starts ``0.3 + u_t`` s in, ``u`` the keyed stream's draws
    for protocol seed ``seed`` (:func:`_trial_starts`)."""
    baseline = _check_scope(sensor, host_baseline_w)
    u = _trial_starts(np.array([seed]), cfg.n_trials)[0].tolist()
    dur = workload.duration_s
    reps = int(_reps_for(dur, cfg))

    part_time = calib.sampled_fraction < 0.999
    W = calib.time_shift_s
    shifts = cfg.n_phase_shifts if part_time else 0
    train0 = _build_train(workload.timeline, reps, shifts, W)
    rise = calib.rise_time_s if (cfg.discard_rise and
                                 np.isfinite(calib.rise_time_s)) else 0.0
    n_skip = min(int(np.ceil(rise / max(dur, 1e-6))), reps - 1)
    kept = reps - n_skip
    gaps_inside = _gaps_between(n_skip, reps, shifts, reps)

    trial_values: List[float] = []
    for trial in range(cfg.n_trials):
        start = 0.3 + u[trial]                          # randomised delay
        train = train0.shift(start - train0.t_start)
        sensor.attach(train, t_end=train.t_end + 2.0)
        ts, vals = sensor.poll(0.0, train.t_end + 1.0,
                               period_s=cfg.poll_period_s)
        vals = vals - baseline
        if cfg.apply_calibration and calib.gain:
            vals = (vals - (calib.offset_w or 0.0)) / calib.gain
        if cfg.time_shift:
            ts = ts - W                 # reading at t covers [t-W, t]
        # the kept repetitions' span inside the train, gaps included
        t_begin = start + _train_offset(n_skip, dur, shifts, reps, W)
        t_end = start + _train_offset(reps, dur, shifts, reps, W)
        e = _integrate_readings(ts, vals, t_begin, t_end)
        e -= gaps_inside * W * workload.timeline.idle_w
        trial_values.append(e / kept)

    arr = np.asarray(trial_values)
    return EnergyEstimate(float(np.mean(arr)), float(np.std(arr)),
                          cfg.n_trials, reps, trial_values)


def compare_protocols(sensor: "OnboardSensor", workload: Workload,
                      calib: CalibrationRecord,
                      cfg: GoodPracticeConfig = GoodPracticeConfig(),
                      seed: int = 0,
                      host_baseline_w: Optional[float] = None) -> dict:
    """Fig. 18: naive error vs good-practice error for one workload."""
    truth = workload.true_energy_j
    naive = measure_naive(sensor, workload, host_baseline_w=host_baseline_w,
                          start_offset_s=0.3 + (seed % 17) * 0.037)
    gp = measure_good_practice(sensor, workload, calib, cfg, seed=seed,
                               host_baseline_w=host_baseline_w)
    return {
        "workload": workload.name,
        "truth_j": truth,
        "naive_j": naive,
        "naive_err": (naive - truth) / truth,
        "gp_j": gp.joules_per_rep,
        "gp_err": gp.error_vs(truth),
        "gp_std_j": gp.std_j,
    }


# ---------------------------------------------------------------------------
# §5.1 repetition trains
# ---------------------------------------------------------------------------

def _build_train(timeline: ActivityTimeline, reps: int, shifts: int,
                 W: float) -> ActivityTimeline:
    """The §5.1 repetition train: ``reps`` back-to-back repetitions, with
    an idle gap of one window-length after every complete group when
    phase-shift delays are in play (part-time sensors)."""
    if shifts > 0:
        group = max(1, reps // shifts)
        parts = []
        done = 0
        while done < reps:
            k = min(group, reps - done)
            parts.append(timeline.repeat(k))
            done += k
        return ActivityTimeline.concat(parts, gap_s=W)
    return timeline.repeat(reps)


def _insert(x: torch.Tensor, pos: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """``np.insert(x, pos, vals)`` for sorted, distinct ``pos``."""
    k = pos.shape[0]
    out = torch.empty(x.shape[0] + k, dtype=x.dtype)
    at = pos + torch.arange(k)
    keep = torch.ones(out.shape[0], dtype=torch.bool)
    keep[at] = False
    out[at] = vals
    out[keep] = x
    return out


def _train_arrays(timeline: ActivityTimeline, reps: int, shifts: int,
                  W: float):
    """(edges, powers) of the §5.1 repetition train, built directly as
    flat CPU tensors (the reference's ``_train_arrays``): repetition
    offsets are ``r·dur`` plus the gaps before them.  One device's train:
    :func:`_train_bank` builds a bank's rows of it at once."""
    rel = timeline.edges - timeline.t_start
    p = timeline.powers
    s = len(p)
    dur = float(rel[-1])
    r = torch.arange(reps)
    if shifts > 0:
        group = max(1, reps // shifts)
        gaps = torch.clamp_max(r // group, (reps - 1) // group)
    else:
        gaps = torch.zeros(reps, dtype=I64)
    off = r.to(F64) * dur + gaps.to(F64) * W
    starts = (rel[None, :s] + off[:, None]).reshape(-1)
    powers = p.repeat(reps)
    gap_rows = torch.nonzero(torch.diff(gaps) > 0)[:, 0] + 1
    if len(gap_rows):
        pos = gap_rows * s
        starts = _insert(starts, pos, off[gap_rows] - W)
        powers = _insert(powers, pos,
                         torch.full((len(pos),), timeline.idle_w,
                                    dtype=F64))
    edges = torch.cat([starts, (off[-1] + dur)[None]]) + timeline.t_start
    return edges, powers


def _train_bank(ws: WorkloadSet, rows: np.ndarray, reps: np.ndarray,
                shifts: int, W: float) -> TimelineBank:
    """Per-device repetition trains of workload rows ``rows`` as one
    :class:`TimelineBank` on the workload bank's device, built in tensor
    ops over [rows, reps, segments]: row ``g`` is
    ``_train_arrays(row rows[g], reps[g], shifts, W)``, each value by the
    same arithmetic, so bit for bit.  Rep ``r``'s segment ``j`` lands at
    ``r·k + j + gaps(r)`` (the gaps inserted before it), the gap before
    rep ``r`` at ``r·k + gaps(r) - 1``, and the train's end at
    ``reps·k + gaps(reps - 1)``; every other target is unique, so the
    scatters are exact.  One host read: the widest train."""
    tl = ws.timeline_bank
    dev = tl.device
    with spans.read("audit.train", 2):
        rows_t = torch.as_tensor(np.asarray(rows), device=dev)
        n_reps = torch.as_tensor(np.asarray(reps, dtype=np.int64),
                                 device=dev)
    e, p = tl.edges[rows_t], tl.powers[rows_t]
    idle, k = tl.idle_w[rows_t], tl.n_segs[rows_t]
    g, smax = p.shape
    rmax = int(np.max(reps))
    t0 = e[:, 0]
    rel = e - t0[:, None]
    dur = torch.gather(rel, 1, k[:, None])[:, 0]
    r = torch.arange(rmax, device=dev)
    if shifts > 0:
        group = torch.clamp_min(n_reps // shifts, 1)
        gaps = torch.minimum(r[None, :] // group[:, None],
                             ((n_reps - 1) // group)[:, None])
    else:
        gaps = torch.zeros((g, rmax), dtype=I64, device=dev)
    off = r.to(F64)[None, :] * dur[:, None] + gaps.to(F64) * W
    live_rep = r[None, :] < n_reps[:, None]
    n_out = n_reps * k + torch.gather(gaps, 1, (n_reps - 1)[:, None])[:, 0]
    with spans.read("audit.train"):
        width = int(n_out.max())
    drop = width + 1                  # a column no kept value lands in

    j = torch.arange(smax, device=dev)
    seg = live_rep[:, :, None] & (j[None, None, :] < k[:, None, None])
    at = (r[None, :, None] * k[:, None, None] + j[None, None, :]
          + gaps[:, :, None])
    at = torch.where(seg, at, drop).reshape(g, -1)
    new_gap = torch.cat([torch.zeros((g, 1), dtype=torch.bool, device=dev),
                         gaps[:, 1:] > gaps[:, :-1]], dim=1) & live_rep
    at_gap = torch.where(new_gap, r[None, :] * k[:, None] + gaps - 1, drop)

    edges = torch.zeros((g, width + 2), dtype=F64, device=dev)
    edges.scatter_(1, at, ((rel[:, None, :smax] + off[:, :, None])
                           + t0[:, None, None]).reshape(g, -1))
    edges.scatter_(1, at_gap, (off - W) + t0[:, None])
    end = torch.gather(off, 1, (n_reps - 1)[:, None])[:, 0]
    edges.scatter_(1, n_out[:, None], ((end + dur) + t0)[:, None])
    powers = idle[:, None].repeat(1, width + 2)
    powers.scatter_(1, at, p[:, None, :].expand(g, rmax, smax).reshape(g, -1))
    return TimelineBank(edges[:, :width + 1], powers[:, :width], idle, n_out)


def _reps_for(durations, cfg: GoodPracticeConfig) -> np.ndarray:
    """Per-device repetition counts (≥ min_reps, ≥ min_total_s of runtime,
    capped at max_reps) on the host."""
    dur = np.asarray(durations, dtype=np.float64)
    reps = np.maximum(cfg.min_reps,
                      np.ceil(cfg.min_total_s
                              / np.maximum(dur, 1e-6)).astype(np.int64))
    return np.minimum(reps, cfg.max_reps)


def _n_gaps_before(rep_idx: int, shifts: int, reps: int) -> int:
    """Inserted W-gaps before the start of repetition ``rep_idx``: one
    after every complete group of ``reps // shifts``, none after the
    last repetition."""
    if shifts <= 0:
        return 0
    group = max(1, reps // shifts)
    return min(rep_idx // group, (reps - 1) // group)


def _train_offset(rep_idx: int, dur: float, shifts: int, reps: int,
                  W: float) -> float:
    """Wall-clock offset of the start of repetition ``rep_idx`` (or, for
    ``rep_idx == reps``, the end of the train)."""
    return rep_idx * dur + _n_gaps_before(rep_idx, shifts, reps) * W


def _gaps_between(i0: int, i1: int, shifts: int, reps: int) -> int:
    """Inserted gaps between the start of rep i0 and the end of rep
    i1-1."""
    return (_n_gaps_before(i1, shifts, reps)
            - _n_gaps_before(i0, shifts, reps))


# ---------------------------------------------------------------------------
# Batched protocols
# ---------------------------------------------------------------------------

def _check_scope_bank(bank: "SensorBank",
                      host_baseline_w: Optional[float]) -> float:
    if bank.module_scope.any() and host_baseline_w is None:
        name = bank.profiles[int(np.argmax(bank.module_scope))].name
        raise ModuleScopeError(
            f"profile '{name}' measures the whole module (GPU+CPU+DRAM); "
            "supply host_baseline_w to subtract, or use a chip-scope profile")
    return host_baseline_w or 0.0


def _baseline_rows(bank: "SensorBank", baseline: float) -> torch.Tensor:
    """Per-device baseline [N] on the bank's device: the host baseline is
    debited from module-scope rows only (chip-scope sensors never see
    host power)."""
    with spans.read("audit.upload"):
        return torch.as_tensor(np.where(bank.module_scope, baseline, 0.0),
                               dtype=F64, device=bank.device)


def as_workload_set(workload: Union[Workload, Sequence[Workload],
                                    WorkloadSet],
                    n_devices: int,
                    device: DeviceLike = "cuda") -> Optional[WorkloadSet]:
    """Normalise a protocol's workload argument: ``None`` for one shared
    :class:`Workload`, else a :class:`WorkloadSet` (built on ``device``
    from a sequence) checked against the fleet size."""
    if isinstance(workload, Workload):
        return None
    ws = (workload if isinstance(workload, WorkloadSet)
          else WorkloadSet(workload, device=device))
    if len(ws) != n_devices:
        raise ValueError(f"{len(ws)} workloads for {n_devices} devices")
    return ws


def _trial_starts(seeds: np.ndarray, n_trials: int,
                  device: DeviceLike = "cpu") -> torch.Tensor:
    """Uniform [0, 1) trial-start draws [n, n_trials] on ``device``.

    Draw ``t`` of row ``i`` is the keyed stream's uniform at counter
    (``seeds[i]``, ``t``) under its own tag, so a device's draws depend on
    its protocol seed alone (not on which devices share the call, nor on
    the device), at O(n) per call.  (The reference draws
    ``default_rng(seed)`` per device; the parity tests substitute its
    draws here.)"""
    seeds = np.asarray(seeds, dtype=np.int64)
    if seeds.min() < 0:
        raise ValueError("protocol seeds must be non-negative")
    keyed_rng.check_index("protocol seed", int(seeds.max()))
    dev = resolve_device(device)
    with spans.read("audit.upload"):
        rows = torch.as_tensor(seeds, device=dev)[:, None]
    return keyed_rng.uniform(0, rows,
                             torch.arange(n_trials, device=dev)[None, :],
                             keyed_rng.TAG_TRIAL)


def measure_naive_batch(bank: "SensorBank",
                        workload: Union[Workload, Sequence[Workload],
                                        WorkloadSet],
                        start_offset_s: float = 0.3,
                        host_baseline_w: Optional[float] = None,
                        poll_period_s: float = 0.001) -> torch.Tensor:
    """Naive protocol for every device of ``bank`` at once: one run of
    ``workload`` (shared, or one per device) from ``start_offset_s``,
    polled every ``poll_period_s`` and integrated over the execution
    window.  Returns per-device joules [N] on the bank's device.
    ``host_baseline_w`` is debited from module-scope rows only."""
    baseline = _check_scope_bank(bank, host_baseline_w)
    transform = None
    if baseline and bank.module_scope.any():
        base = _baseline_rows(bank, baseline)[:, None]

        def transform(v):
            return v - base
    ws = as_workload_set(workload, bank.n_devices, bank.device)
    if ws is None:
        tl = workload.timeline.shift(start_offset_s
                                     - workload.timeline.t_start)
        bank.attach(tl, t_end=tl.t_end + 1.0)
        return bank.integrate_polled(
            0.0, tl.t_end + 0.5, poll_period_s,
            start_offset_s, start_offset_s + workload.duration_s,
            transform=transform)
    tlb = ws.timeline_bank
    tlb = tlb.shift(start_offset_s - tlb.t_start)
    bank.attach(tlb, t_end=tlb.t_end + 1.0)
    return bank.integrate_polled(
        0.0, tlb.t_end + 0.5, poll_period_s,
        start_offset_s, start_offset_s + ws.durations_s,
        transform=transform)


def measure_good_practice_batch(
        bank: "SensorBank",
        workload: Union[Workload, Sequence[Workload], WorkloadSet],
        calib: Union[CalibrationRecord, Dict[str, CalibrationRecord]],
        cfg: GoodPracticeConfig = GoodPracticeConfig(),
        host_baseline_w: Optional[float] = None,
        seeds: Optional[np.ndarray] = None) -> BatchedEnergyEstimate:
    """The §5 protocol for every device of ``bank`` at once.

    Devices are grouped by profile name (the train's layout follows the
    calibration's window); within a group, each trial attaches the whole
    group to the repetition train (shared, or one per device from a
    :class:`WorkloadSet`) at per-device random start offsets and
    integrates the re-synchronised readings over the kept repetitions.
    Device ``i``'s start offsets follow from its protocol seed
    ``seeds[i]`` (default ``arange(N)``) alone.  ``calib`` is one record
    or a dict keyed by profile name.
    """
    n = bank.n_devices
    dev = bank.device
    baseline = _check_scope_bank(bank, host_baseline_w)
    ws = as_workload_set(workload, n, dev)
    seeds = np.arange(n) if seeds is None else np.asarray(seeds,
                                                          dtype=np.int64)
    if isinstance(calib, CalibrationRecord):
        calibs = {p.name: calib for p in bank.profiles}
    else:
        calibs = calib
    u = _trial_starts(seeds, cfg.n_trials, dev)

    trials = torch.zeros((n, cfg.n_trials), dtype=F64, device=dev)
    reps_out = np.zeros(n, dtype=np.int64)
    names = np.array([p.name for p in bank.profiles])
    for name in sorted(set(names)):
        rows = np.nonzero(names == name)[0]
        with spans.read("audit.upload"):
            rows_t = torch.as_tensor(rows, device=dev)
        sub = bank.subset(rows)
        cal = calibs[name]
        part_time = cal.sampled_fraction < 0.999
        W = cal.time_shift_s
        shifts = cfg.n_phase_shifts if part_time else 0
        rise = cal.rise_time_s if (cfg.discard_rise and
                                   np.isfinite(cal.rise_time_s)) else 0.0
        starts = 0.3 + u[rows_t]
        base = _baseline_rows(sub, baseline)[:, None]

        def transform(v, cal=cal, base=base):
            v = v - base
            if cfg.apply_calibration and cal.gain:
                v = (v - (cal.offset_w or 0.0)) / cal.gain
            return v

        offset = -W if cfg.time_shift else 0.0
        if ws is None:
            dur = workload.duration_s
            reps = int(_reps_for(dur, cfg))
            train = _build_train(workload.timeline, reps, shifts, W)
            n_skip = min(int(np.ceil(rise / max(dur, 1e-6))), reps - 1)
            kept = reps - n_skip
            off_begin = _train_offset(n_skip, dur, shifts, reps, W)
            off_end = _train_offset(reps, dur, shifts, reps, W)
            gaps = _gaps_between(n_skip, reps, shifts, reps)
            idle = workload.timeline.idle_w
            reps_out[rows] = reps
            length = train.t_end - train.t_start
            for t in range(cfg.n_trials):
                start = starts[:, t]
                shift = start - train.t_start
                sub.attach(train, t_end=train.t_end + shift + 2.0,
                           shifts=shift)
                e = sub.integrate_polled(
                    0.0, start + length + 1.0, cfg.poll_period_s,
                    start + off_begin, start + off_end,
                    transform=transform, grid_offset=offset)
                e = e - gaps * W * idle
                trials[rows_t, t] = e / kept
        else:
            dur_t = ws.durations_s[rows_t]
            with spans.read("audit.durations"):
                dur = dur_t.cpu().numpy()
            reps = _reps_for(dur, cfg)
            n_skip = np.minimum(
                np.ceil(rise / np.maximum(dur, 1e-6)).astype(np.int64),
                reps - 1)
            if shifts > 0:
                group = np.maximum(1, reps // shifts)
                gb = np.minimum(n_skip // group, (reps - 1) // group)
                ge = np.minimum(reps // group, (reps - 1) // group)
            else:
                gb = ge = np.zeros(len(rows), dtype=np.int64)

            def f64(x):
                return torch.as_tensor(x, dtype=F64, device=dev)
            with spans.read("audit.upload", 6):
                kept = f64(reps - n_skip)
                off_begin = f64(n_skip) * dur_t + f64(gb) * W
                off_end = f64(reps) * dur_t + f64(ge) * W
                gaps = f64(ge - gb)
            tb0 = _train_bank(ws, rows, reps, shifts, W)
            idle = tb0.idle_w
            reps_out[rows] = reps
            for t in range(cfg.n_trials):
                start = starts[:, t]
                tb = tb0.shift(start - tb0.t_start)
                sub.attach(tb, t_end=tb.t_end + 2.0)
                e = sub.integrate_polled(
                    0.0, tb.t_end + 1.0, cfg.poll_period_s,
                    start + off_begin, start + off_end,
                    transform=transform, grid_offset=offset)
                e = e - gaps * W * idle
                trials[rows_t, t] = e / kept

    with spans.read("audit.upload"):
        reps_t = torch.as_tensor(reps_out, device=dev)
    return BatchedEnergyEstimate(trials.mean(dim=1),
                                 trials.std(dim=1, correction=0),
                                 cfg.n_trials, reps_t, trials)
