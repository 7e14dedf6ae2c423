"""Plain PyTorch versions of the engine ops on the monitor's main path.

The counterparts of :mod:`repro.core.engine_backend.numpy_backend`
(the reference semantics), formula for formula, on tensors of any
device.  They serve three roles:

* the query-side and source-side ops (``searchsorted_rows``,
  ``timeline_integral``, ``boxcar_means``, ``query_slots``,
  ``snapshot_energy_at``, ``err_moments``) run as they are, on the card
  or the CPU: the JAX package had no TPU kernel for them either;
* ``stream_ingest`` and ``stream_ingest_grid`` are the plain versions of
  the two CUDA kernels in :mod:`repro_torch.kernels`: the kernel
  wrappers run them for CPU tensors, and ``chip_smoke.py`` holds each
  kernel against them on the card.

``np.bincount`` becomes ``index_add_``, ``np.maximum.accumulate``
becomes ``torch.cummax`` and ``take_along_axis`` becomes ``gather``.
Float sums by ``index_add_`` run in index order on the CPU (as
``np.bincount`` does) but in no fixed order on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.engine_backend.pytrees import ReadingSchedule, TimelineArrays

F64 = torch.float64
I64 = torch.int64


def searchsorted_rows(a: torch.Tensor, v: torch.Tensor,
                      side: str = "right") -> torch.Tensor:
    """Row-wise ``searchsorted``: sorted rows ``a`` [R, S] against query
    rows ``v`` [G, M], where R == G or R == 1 (row broadcast).  Rows may
    be ``+inf``-padded; the result is what
    ``np.searchsorted(a[i], v[i], side)`` returns per row."""
    if side not in ("left", "right"):
        raise ValueError(f"bad side '{side}'")
    r = a.shape[0]
    g = v.shape[0]
    if r not in (1, g):
        raise ValueError(f"cannot broadcast {r} rows against {g} queries")
    right = side == "right"
    if r == 1:
        return torch.searchsorted(a[0].contiguous(), v.contiguous(),
                                  right=right)
    return torch.searchsorted(a.contiguous(), v.contiguous(), right=right)


def _expand_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    return x if x.shape[0] == g else x.expand(g, *x.shape[1:])


def cum_energy(tl: TimelineArrays) -> torch.Tensor:
    """Per-row cumulative segment energy [R, S+1] (zero at the first edge)."""
    seg = tl.powers * torch.diff(tl.edges, dim=1)
    zero = torch.zeros((tl.n_rows, 1), dtype=F64, device=seg.device)
    return torch.cat([zero, torch.cumsum(seg, dim=1)], dim=1)


def timeline_integral(tl: TimelineArrays, t0: torch.Tensor,
                      t1: torch.Tensor) -> torch.Tensor:
    """Exact per-row ∫P_i dt over [t0_i, t1_i] [G, M]; idle outside
    coverage.  ``tl`` has G rows, or 1 row broadcast against G."""
    g = t0.shape[0]
    if tl.n_rows not in (1, g):
        raise ValueError(f"{g} query rows for {tl.n_rows} timeline rows")
    cum = _expand_rows(cum_energy(tl), g)
    e_rows = tl.edges
    e = _expand_rows(tl.edges, g)
    p = _expand_rows(tl.powers, g)
    idle = _expand_rows(tl.idle_w, g)[:, None]
    first = e[:, :1]
    last = e[:, -1:]
    hi_idx = torch.clamp_min(_expand_rows(tl.n_segs, g) - 1, 0)[:, None]

    def eval_i(t):
        tc = torch.minimum(torch.maximum(t, first), last)
        pos = searchsorted_rows(e_rows, tc, "right") - 1
        idx = torch.minimum(torch.clamp_min(pos, 0), hi_idx)
        inner = (torch.gather(cum, 1, idx)
                 + torch.gather(p, 1, idx) * (tc - torch.gather(e, 1, idx)))
        before = torch.clamp_max(t - first, 0.0) * idle
        after = torch.clamp_min(t - last, 0.0) * idle
        return inner + before + after

    return eval_i(t1) - eval_i(t0)


def boxcar_means(tl: TimelineArrays, t0: torch.Tensor,
                 t1: torch.Tensor) -> torch.Tensor:
    """Batched trailing-window means ∫P dt / (t1 - t0) over [G, M]
    windows: the boxcar transient's raw reading."""
    dt = torch.clamp_min(t1 - t0, 1e-12)
    return timeline_integral(tl, t0, t1) / dt


def query_slots(sched: ReadingSchedule, tq: torch.Tensor) -> torch.Tensor:
    """Reading slot current at wall-clock times ``tq`` [N, K]: the
    arithmetic index ``floor((t - phase) / T) - k0``, settled against the
    stored tick values in two passes each way and clamped to each
    device's valid range."""
    ticks = sched.ticks
    m = ticks.shape[1]
    T = sched.update_period_s[:, None]
    phase = sched.phase[:, None]
    j = torch.floor((tq - phase) / T).to(I64) - sched.k0[:, None]
    j = torch.clamp(j, 0, m - 1)
    # the arithmetic index can be off by one ulp at tick boundaries
    for _ in range(2):
        tj = torch.gather(ticks, 1, j)
        j = torch.where((tj > tq) & (j > 0), j - 1, j)
    for _ in range(2):
        jn = torch.clamp_max(j + 1, m - 1)
        tn = torch.gather(ticks, 1, jn)
        j = torch.where((tn <= tq) & (jn > j), jn, j)
    return torch.minimum(torch.maximum(j, sched.first[:, None]),
                         sched.last[:, None])


def snapshot_energy_at(tq: torch.Tensor, last_t: torch.Tensor,
                       dens: torch.Tensor, has: torch.Tensor,
                       first_t: torch.Tensor, base: torch.Tensor,
                       max_hold: torch.Tensor,
                       ring_t: Optional[torch.Tensor],
                       ring_dens: Optional[torch.Tensor],
                       ring_base: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy since first sample at ``Q`` instants ``tq`` for all ``N``
    devices: ``(e, covered)`` [Q, N], nan where an instant predates ring
    coverage.  ``ring_*`` [N, R] is the sorted ring view (``+inf`` in
    unused slots) or None when the ring is disabled."""
    tq = tq[:, None]                                       # [Q, 1]
    dt = tq - last_t[None, :]
    hold = torch.minimum(dt, max_hold[None, :])
    live = has[None, :] & (dt >= 0.0)
    zero = torch.zeros((), dtype=F64, device=tq.device)
    e_live = torch.where(live, base[None, :] + dens[None, :] * hold, zero)
    covered = live | ~has[None, :] | (tq <= first_t[None, :])
    started = has[None, :] & (tq > first_t[None, :])
    e = torch.where(started, e_live, zero)
    past = started & (tq < last_t[None, :])
    if ring_t is not None and bool(past.any()):
        rows = tq.T.expand(ring_t.shape[0], tq.shape[0])
        j = searchsorted_rows(ring_t, rows, "right") - 1    # [N, Q]
        ok = j >= 0
        jc = torch.clamp(j, 0, ring_t.shape[1] - 1)
        rt = torch.gather(ring_t, 1, jc)
        rd = torch.gather(ring_dens, 1, jc)
        rb = torch.gather(ring_base, 1, jc)
        hold_p = torch.minimum(tq - rt.T, max_hold[None, :])
        # unused slots hold t=inf: 0*inf is nan there, masked by sel
        e_past = rb.T + rd.T * hold_p
        sel = past & ok.T
        e = torch.where(sel, e_past, e)
        covered = covered | sel
    nan = torch.full((), float("nan"), dtype=F64, device=tq.device)
    return torch.where(covered, e, nan), covered


def err_moments(e: torch.Tensor) -> Tuple[int, float, float, float, float]:
    """``(count, mean, M2, mean_abs, max_abs)`` of one block, for the
    Chan merge of :class:`~repro_torch.core.fleet_engine.StreamingMoments`."""
    n = int(e.numel())
    if n == 0:
        return 0, 0.0, 0.0, 0.0, 0.0
    e = e.to(F64)
    mean = e.mean()
    ae = e.abs()
    out = torch.stack([mean, ((e - mean) ** 2).sum(), ae.mean(), ae.max()])
    m, m2, ma, mx = out.tolist()
    return n, m, m2, ma, mx


def _empty(cls, n_rows: int, sample_shape: tuple, device: torch.device):
    """Uninitialised outputs of kernel output tuple ``cls``: ``[n_rows]``
    per device or group, ``sample_shape`` per sample."""
    return cls._make(
        torch.empty(sample_shape if f in cls.PER_SAMPLE else (n_rows,),
                    dtype=cls.DTYPES.get(f, F64), device=device)
        for f in cls._fields)


class IngestOut(NamedTuple):
    """What :func:`stream_ingest` returns: per group [U], then per
    sample [K].  The CUDA kernel's argument struct lists its output
    pointers in this field order."""

    new_t: torch.Tensor
    new_v: torch.Tensor
    new_run_t: torch.Tensor
    new_n_changes: torch.Tensor
    counts: torch.Tensor
    d_energy: torch.Tensor
    d_energy_corr: torch.Tensor
    d_win: torch.Tensor
    d_win_corr: torch.Tensor
    sum_vc: torch.Tensor
    sum_vc2: torch.Tensor
    sum_abs_vc: torch.Tensor
    max_abs_vc: torch.Tensor
    n_out: torch.Tensor
    cum_e: torch.Tensor
    cum_ec: torch.Tensor
    vc: torch.Tensor
    run_dur: torch.Tensor
    run_rec: torch.Tensor

    #: fields a kernel reproduces bitwise (carried readings, counters, run
    #: tracking, flags, elementwise values); the rest are sums of floats
    BITWISE = ("new_t", "new_v", "new_run_t", "new_n_changes", "counts",
               "max_abs_vc", "n_out", "vc", "run_dur", "run_rec")
    PER_SAMPLE = ("cum_e", "cum_ec", "vc", "run_dur", "run_rec")
    DTYPES = {"new_n_changes": I64, "counts": I64, "n_out": I64,
              "run_rec": torch.bool}
    empty = classmethod(_empty)


class IngestGridOut(NamedTuple):
    """What :func:`stream_ingest_grid` returns: per device [D], then per
    sample [D, M], in the CUDA kernel's output pointer order."""

    new_v: torch.Tensor
    new_run_t: torch.Tensor
    new_n_changes: torch.Tensor
    d_energy: torch.Tensor
    d_energy_corr: torch.Tensor
    d_win: torch.Tensor
    d_win_corr: torch.Tensor
    sum_vc: torch.Tensor
    sum_vc2: torch.Tensor
    sum_abs_vc: torch.Tensor
    max_abs_vc: torch.Tensor
    n_out: torch.Tensor
    cum_e: torch.Tensor
    cum_ec: torch.Tensor
    run_dur: torch.Tensor
    run_rec: torch.Tensor

    BITWISE = ("new_v", "new_run_t", "new_n_changes", "max_abs_vc",
               "n_out", "run_dur", "run_rec")
    PER_SAMPLE = ("cum_e", "cum_ec", "run_dur", "run_rec")
    DTYPES = {"new_n_changes": I64, "n_out": I64, "run_rec": torch.bool}
    empty = classmethod(_empty)


def _segment_sum(seg: torch.Tensor, w: torch.Tensor, u: int) -> torch.Tensor:
    """``np.bincount(seg, weights=w, minlength=u)`` in ``w``'s dtype."""
    return torch.zeros(u, dtype=w.dtype, device=w.device).index_add_(0, seg, w)


def stream_ingest(t, v, seg, first, start_idx, end_idx, prev_t, prev_v,
                  has_prev, run_t, n_changes, gain, offset, tshift, win_a,
                  win_b, max_hold, env_lo, env_hi, trapezoid: bool = False
                  ) -> IngestOut:
    """One slab of the streaming monitor's hot path: ``K`` samples sorted
    by (device, time) and compacted to ``U`` groups (``seg`` [K] group
    ids, ``first`` [K] group starts, ``start_idx``/``end_idx`` [U]
    boundaries), with the gathered per-group state and correction
    parameters [U].  See ``repro.core.engine_backend.numpy_backend.
    stream_ingest`` for the semantics of every argument.

    Returns an :class:`IngestOut`: the reference's outputs plus each
    group's Σvc², Σ|vc| and max|vc| (the per-label reading moments).
    """
    k = t.shape[0]
    u = prev_t.shape[0]
    dev = t.device
    idx = torch.arange(k, device=dev)
    zero = torch.zeros((), dtype=F64, device=dev)

    # previous sample within the slab, or the stored state at group starts
    shift_t = torch.cat([zero[None], t[:-1]])
    shift_v = torch.cat([zero[None], v[:-1]])
    pt = torch.where(first, prev_t[seg], shift_t)
    pv = torch.where(first, prev_v[seg], shift_v)
    has = torch.where(first, has_prev[seg], True)

    g = gain[seg]
    off = offset[seg]
    vc = (v - off) / g
    pvc = (pv - off) / g
    dt = t - pt
    hold = torch.minimum(dt, max_hold[seg])
    dens_r = 0.5 * (pv + v) if trapezoid else pv
    dens_c = 0.5 * (pvc + vc) if trapezoid else pvc
    inc = torch.where(has, dens_r * hold, zero)
    inc_c = torch.where(has, dens_c * hold, zero)

    # within-group inclusive prefixes: the slab-wide cumsum re-based at
    # each group's start
    cs = torch.cumsum(inc, 0)
    cum_e = cs - (cs[start_idx] - inc[start_idx])[seg]
    csc = torch.cumsum(inc_c, 0)
    cum_ec = csc - (csc[start_idx] - inc_c[start_idx])[seg]
    d_energy = cum_e[end_idx]
    d_energy_corr = cum_ec[end_idx]

    # registered windows (the corrected flavour uses reported times)
    a = win_a[seg]
    b = win_b[seg]
    w_inc = torch.where(
        has & (pt >= a),
        dens_r * torch.clamp_min(torch.minimum(pt + hold, b) - pt, 0.0), zero)
    pts = pt - tshift[seg]
    w_inc_c = torch.where(
        has & (pts >= a),
        dens_c * torch.clamp_min(torch.minimum(pts + hold, b) - pts, 0.0),
        zero)
    d_win = _segment_sum(seg, w_inc, u)
    d_win_corr = _segment_sum(seg, w_inc_c, u)

    # run tracking: a change closes the run opened by the previous change
    # (or by the carried run_t); only runs with a change on both sides
    # are recorded
    change = has & (v != pv)
    ci = torch.where(change, idx, -1)
    acc = torch.cummax(ci, 0).values
    acc_excl = torch.cat([acc.new_full((1,), -1), acc[:-1]])
    gstart = start_idx[seg]
    prev_chg = torch.where(acc_excl >= gstart, acc_excl, -1)
    run_start = torch.where(prev_chg >= 0, t[torch.clamp_min(prev_chg, 0)],
                            run_t[seg])
    run_dur = torch.where(change, t - run_start, zero)
    chg = change.to(I64)
    cchg = torch.cumsum(chg, 0)
    chg_before_slab = cchg - (cchg[start_idx] - chg[start_idx])[seg] - chg
    run_rec = change & (n_changes[seg] + chg_before_slab >= 1)

    acc_end = acc[end_idx]
    new_run_t = torch.where(acc_end >= start_idx,
                            t[torch.clamp_min(acc_end, 0)], run_t)
    new_n_changes = n_changes + _segment_sum(seg, chg, u)

    counts = torch.bincount(seg, minlength=u).to(I64)
    av = vc.abs()
    max_abs_vc = torch.zeros(u, dtype=F64, device=dev).scatter_reduce(
        0, seg, av, "amax", include_self=True)
    out = (vc < env_lo[seg]) | (vc > env_hi[seg])
    n_out = _segment_sum(seg, out.to(I64), u)

    return IngestOut(t[end_idx], v[end_idx], new_run_t, new_n_changes,
                     counts, d_energy, d_energy_corr, d_win, d_win_corr,
                     _segment_sum(seg, vc, u), _segment_sum(seg, vc * vc, u),
                     _segment_sum(seg, av, u), max_abs_vc, n_out,
                     cum_e, cum_ec, vc, run_dur, run_rec)


def stream_ingest_grid(ts, v, prev_t, prev_v, has_prev, run_t, n_changes,
                       gain, offset, tshift, win_a, win_b, max_hold, env_lo,
                       env_hi, trapezoid: bool = False
                       ) -> IngestGridOut:
    """Rectangular fast path of :func:`stream_ingest`: ``D`` devices share
    one strictly-increasing time axis ``ts`` [M] with readings ``v``
    [D, M]; every accumulator is a row-wise scan or reduction.

    Returns an :class:`IngestGridOut`.
    """
    d, m = v.shape
    dev = v.device
    if m == 0:      # empty slab: state passes through untouched
        z = torch.zeros((d, 0), dtype=F64, device=dev)
        zd = lambda: torch.zeros(d, dtype=F64, device=dev)   # noqa: E731
        return IngestGridOut(
            prev_v.clone(), run_t.clone(), n_changes.clone(),
            zd(), zd(), zd(), zd(), zd(), zd(), zd(), zd(),
            torch.zeros(d, dtype=I64, device=dev), z, z.clone(), z.clone(),
            torch.zeros((d, 0), dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=F64, device=dev)

    # previous sample per column: the stored state at column 0
    pt = torch.cat([prev_t[:, None], ts[:-1][None, :].expand(d, m - 1)], 1)
    pv = torch.cat([prev_v[:, None], v[:, :-1]], 1)
    has = torch.ones((d, m), dtype=torch.bool, device=dev)
    has[:, 0] = has_prev

    g = gain[:, None]
    off = offset[:, None]
    vc = (v - off) / g
    pvc = (pv - off) / g
    dt = ts[None, :] - pt
    hold = torch.minimum(dt, max_hold[:, None])
    dens_r = 0.5 * (pv + v) if trapezoid else pv
    dens_c = 0.5 * (pvc + vc) if trapezoid else pvc
    inc = torch.where(has, dens_r * hold, zero)
    inc_c = torch.where(has, dens_c * hold, zero)
    cum_e = torch.cumsum(inc, 1)
    cum_ec = torch.cumsum(inc_c, 1)

    a = win_a[:, None]
    b = win_b[:, None]
    w_inc = torch.where(
        has & (pt >= a),
        dens_r * torch.clamp_min(torch.minimum(pt + hold, b) - pt, 0.0), zero)
    pts = pt - tshift[:, None]
    w_inc_c = torch.where(
        has & (pts >= a),
        dens_c * torch.clamp_min(torch.minimum(pts + hold, b) - pts, 0.0),
        zero)

    change = has & (v != pv)
    cols = torch.arange(m, device=dev)[None, :]
    ci = torch.where(change, cols, -1)
    acc = torch.cummax(ci, 1).values
    acc_excl = torch.cat([acc.new_full((d, 1), -1), acc[:, :-1]], 1)
    run_start = torch.where(acc_excl >= 0, ts[torch.clamp_min(acc_excl, 0)],
                            run_t[:, None])
    run_dur = torch.where(change, ts[None, :] - run_start, zero)
    chg = change.to(I64)
    cchg = torch.cumsum(chg, 1)
    run_rec = change & (n_changes[:, None] + (cchg - chg) >= 1)

    last = acc[:, -1]
    new_run_t = torch.where(last >= 0, ts[torch.clamp_min(last, 0)], run_t)
    new_n_changes = n_changes + cchg[:, -1]

    av = vc.abs()
    out = (vc < env_lo[:, None]) | (vc > env_hi[:, None])
    return IngestGridOut(
        v[:, -1].clone(), new_run_t, new_n_changes, cum_e[:, -1].clone(),
        cum_ec[:, -1].clone(), w_inc.sum(1), w_inc_c.sum(1), vc.sum(1),
        (vc * vc).sum(1), av.sum(1), av.amax(1), out.sum(1).to(I64),
        cum_e, cum_ec, run_dur, run_rec)
