"""The plain reference of the streaming monitor's ingest: what its state
must hold after ``n_slabs`` slabs of a
:class:`~portbench.gen.monitor.MonitorTraffic` stream.

The semantics are the monitor's, stated independently of its code.  A
device's reading is held from its sample until the next one; energy is
the integral of the held readings (raw, and corrected as ``(v - offset) /
gain``), from each device's first sample; a registered window ``[a, b]``
takes the held interval ``[t_prev, t)`` clipped at ``b`` when ``t_prev >=
a`` (the corrected flavour on reported times ``t_prev - time_shift``); a
change of reading closes the run opened by the change before it, and the
update-period estimate is the mean of the runs in the median bin of a
log-spaced histogram; each label keeps the count, mean, spread, mean
magnitude and largest magnitude of its corrected readings (a label is a
workload's scenario); the ring makes
``energy_between`` exact over the newest samples; a second copy of a
sample is a duplicate.

The stream replays a cycle of ``P`` pool ticks at advancing times, so the
reference sums each pool tick's contribution once, weighted by the time
steps of every slab that carried it, instead of folding slab after slab.
Run tracking is followed slab by slab over the first two cycles; from the
second cycle on a tick's runs repeat, and are counted again for each later
slab of that tick; a job window lies within a few slabs, which are read
device by device.  ``dtype`` is the precision the reference computes in
(its control runs it one step lower).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

I64 = torch.int64


def corrections(traffic, dtype) -> Dict[str, torch.Tensor]:
    """The nominal §5 corrections of each device's sensor: no gain or
    offset (uncalibrated), reported times moved back by the averaging
    window (one update period for a sensor without one)."""
    dev, n = traffic.device, traffic.n
    sens = traffic.config["sensors"]
    shift = [sens[u]["window_s"] or sens[u]["update_period_s"]
             for u in traffic.names]
    return {"gain": torch.ones(n, dtype=dtype, device=dev),
            "offset": torch.zeros(n, dtype=dtype, device=dev),
            "shift": torch.tensor(shift, dtype=torch.float64).to(
                dev, dtype),
            "baseline": torch.full((n,), float(
                traffic.config.get("baseline_w", 0.0)), dtype=dtype,
                device=dev)}


def stream_times(traffic, n_slabs: int) -> torch.Tensor:
    """[N, M] the poll times of every slab, as the stream sent them."""
    return torch.stack([traffic.times(i) for i in range(n_slabs)])


def _counts_by_tick(n_slabs: int, pool_ticks: int, start: int = 0):
    """How many slabs ``i`` in ``[start, n_slabs)`` carry each pool
    tick."""
    return [len(range(start + (p - start) % pool_ticks, n_slabs, pool_ticks))
            for p in range(pool_ticks)]


def expected(traffic, n_slabs: int, t_between, dtype=torch.float64) -> dict:
    """The monitor's state after slabs ``0 .. n_slabs - 1``.

    ``t_between`` is the ``(t0, t1)`` of the ``energy_between`` query
    that reads the ring."""
    p_n, m, d, dev = traffic.pool_ticks, traffic.m, traffic.n, traffic.device
    n = int(n_slabs)
    if n < 1:
        raise ValueError("the reference needs at least one slab")
    corr = corrections(traffic, dtype)
    vr = traffic.pool.to(dtype) - corr["baseline"][None, :, None]
    vc = (vr - corr["offset"][None, :, None]) / corr["gain"][None, :, None]
    ts = stream_times(traffic, n).to(dtype)                   # [N, M]
    flat_t = ts.reshape(-1)
    dt = torch.zeros_like(flat_t)
    dt[1:] = flat_t[1:] - flat_t[:-1]
    dt = dt.reshape(n, m)
    tick = torch.arange(n, device=dev) % p_n
    steps = torch.zeros((p_n, m), dtype=dtype, device=dev).index_add_(
        0, tick, dt)
    n_by_tick = _counts_by_tick(n, p_n)
    n_after_first = _counts_by_tick(n, p_n, start=1)

    out: Dict[str, torch.Tensor] = {}
    e = torch.zeros(d, dtype=dtype, device=dev)
    ec = torch.zeros_like(e)
    changes = torch.zeros(d, dtype=I64, device=dev)
    for p in range(p_n):
        q = (p - 1) % p_n
        e = e + vr[p, :, :-1] @ steps[p, 1:] + vr[q, :, -1] * steps[p, 0]
        ec = ec + vc[p, :, :-1] @ steps[p, 1:] + vc[q, :, -1] * steps[p, 0]
        within = (vr[p, :, 1:] != vr[p, :, :-1]).sum(1)
        across = (vr[p, :, 0] != vr[q, :, -1]).to(I64)
        changes += n_by_tick[p] * within + n_after_first[p] * across
    out["energy_j"], out["energy_corr_j"] = e, ec
    out["n_changes"] = changes

    out["win_j"], out["win_corr_j"] = _windows(traffic, vr, vc, n,
                                               corr["shift"], dtype)

    out["period_est"] = _periods(traffic, vr, ts, n, dtype)
    out["moments"] = _moments(traffic, vc, n_by_tick)
    out["between_raw"], out["between_corr"] = (
        _between(x[(n - 1) % p_n], ts[n - 1], t_between, dtype)
        for x in (vr, vc))

    last = ts[n - 1, -1]
    out["first_t"] = ts[0, 0].expand(d).clone()
    out["last_t"] = last.expand(d).clone()
    out["last_v"] = vr[(n - 1) % p_n, :, -1].clone()
    out["has"] = torch.ones(d, dtype=torch.bool, device=dev)
    out["n_samples"] = torch.full((d,), n * m, dtype=I64, device=dev)
    dups = torch.zeros(d, dtype=I64, device=dev)
    if traffic.dup_counts is not None:
        for p in range(p_n):
            dups += n_by_tick[p] * traffic.dup_counts[p]
    out["n_dup"] = dups
    out["n_late"] = torch.zeros(d, dtype=I64, device=dev)
    out["counters"] = {"accepted": n * m * d, "duplicates": int(dups.sum()),
                       "late": 0, "invalid": 0, "rejected": 0,
                       "devices_reporting": d}
    return out


def _windows(traffic, vr, vc, n, shift, dtype):
    """[D] raw and corrected window energies.  Each device's window spans
    a few slabs, so only the slabs around it are read, device by device."""
    p_n, d, dev = traffic.pool_ticks, traffic.n, traffic.device
    a, b = traffic.win_a.to(dtype), traffic.win_b.to(dtype)
    tick = traffic.tick_s
    s0 = torch.floor(traffic.win_a / tick).to(I64) - 1
    s1 = torch.floor((traffic.win_b + shift.to(torch.float64)) / tick).to(
        I64) + 1
    rows = torch.arange(d, device=dev)
    win = torch.zeros(d, dtype=dtype, device=dev)
    winc = torch.zeros_like(win)
    for k in range(int((s1 - s0).max()) + 1):
        s = s0 + k
        live = ((s >= 0) & (s < n) & (s <= s1))[:, None]
        s = torch.clamp(s, 0, n - 1)
        p, q = s % p_n, (s - 1) % p_n
        t = (traffic.pool_ts[p] + (s // p_n).to(torch.float64)[:, None]
             * traffic.cycle_s).to(dtype)
        t_last = (traffic.pool_ts[q, -1] + ((s - 1) // p_n).to(
            torch.float64) * traffic.cycle_s).to(dtype)
        t_prev = torch.cat([t_last[:, None], t[:, :-1]], 1)
        step = t - t_prev
        has = torch.ones_like(t_prev, dtype=torch.bool)
        has[:, 0] = s > 0
        has &= live
        pv = torch.cat([vr[q, rows, -1:], vr[p, rows, :-1]], 1)
        pvc = torch.cat([vc[q, rows, -1:], vc[p, rows, :-1]], 1)
        w = torch.where(has & (t_prev >= a[:, None]), torch.clamp_min(
            torch.minimum(t_prev + step, b[:, None]) - t_prev, 0.0), 0.0)
        win += (pv * w).sum(1)
        t_rep = t_prev - shift[:, None]
        w = torch.where(has & (t_rep >= a[:, None]), torch.clamp_min(
            torch.minimum(t_rep + step, b[:, None]) - t_rep, 0.0), 0.0)
        winc += (pvc * w).sum(1)
    return win, winc


def _periods(traffic, vr, ts, n, dtype) -> torch.Tensor:
    """[D] update-period estimates: nan below ``min_runs`` complete
    runs."""
    cfg = traffic.config
    p_n, d, dev = traffic.pool_ticks, traffic.n, traffic.device
    n_bins, min_runs = int(cfg["period_bins"]), int(cfg["min_runs"])
    edges = torch.tensor(np.geomspace(1e-3, 100.0, n_bins - 1),
                         dtype=torch.float64).to(dev, dtype)
    counts = torch.zeros((d, n_bins), dtype=I64, device=dev)
    sums = torch.zeros((d, n_bins), dtype=dtype, device=dev)
    steady_c = torch.zeros((p_n, d, n_bins), dtype=I64, device=dev)
    steady_s = torch.zeros((p_n, d, n_bins), dtype=dtype, device=dev)
    last_change = torch.full((d,), -float("inf"), dtype=dtype, device=dev)
    for i in range(min(n, 2 * p_n)):
        p, q = i % p_n, (i - 1) % p_n
        v = vr[p]
        prev = torch.cat([vr[q, :, -1:], v[:, :-1]], 1)
        chg = v != prev
        if i == 0:
            chg[:, 0] = False
        rows, cols = chg.nonzero(as_tuple=True)      # by device, then time
        t_chg = ts[i][cols]
        t_before = torch.empty_like(t_chg)
        if t_chg.numel():
            t_before[1:] = t_chg[:-1]
            first = torch.ones_like(rows, dtype=torch.bool)
            first[1:] = rows[1:] != rows[:-1]
            t_before = torch.where(first, last_change[rows], t_before)
        rec = torch.isfinite(t_before)
        dur = (t_chg - t_before)[rec]
        r = rows[rec]
        bins = torch.searchsorted(edges, dur, right=True)
        cnt, tot = ((counts, sums) if i < p_n
                    else (steady_c[p], steady_s[p]))
        cnt.index_put_((r, bins), torch.ones_like(r), accumulate=True)
        tot.index_put_((r, bins), dur, accumulate=True)
        last_change = last_change.scatter_reduce(0, rows, t_chg, "amax",
                                                 include_self=True)
    for p, k in enumerate(_counts_by_tick(n, p_n, start=p_n)):
        counts += k * steady_c[p]
        sums += k * steady_s[p]
    n_runs = counts.sum(1)
    need = (n_runs + 1) // 2
    bstar = (torch.cumsum(counts, 1) >= need[:, None]).to(
        torch.int8).argmax(1)
    cnt = counts.gather(1, bstar[:, None])[:, 0]
    est = sums.gather(1, bstar[:, None])[:, 0] / torch.clamp_min(cnt, 1)
    return torch.where((n_runs >= min_runs) & (cnt > 0), est,
                       float("nan"))


def _moments(traffic, vc, n_by_tick) -> Dict[str, Dict[str, float]]:
    """Per label: the count, mean, standard deviation, mean magnitude and
    largest magnitude of every accepted corrected reading."""
    names = np.asarray(traffic.labels)
    out = {}
    m = traffic.m
    for label in sorted(set(traffic.labels)):
        rows = torch.as_tensor(np.flatnonzero(names == label),
                               device=traffic.device)
        x = vc[:, rows, :]                                   # [P, L, M]
        k = torch.tensor(n_by_tick, dtype=vc.dtype, device=vc.device)
        cnt = sum(n_by_tick) * rows.numel() * m
        s1 = (k * x.sum((1, 2))).sum()
        s2 = (k * (x * x).sum((1, 2))).sum()
        sa = (k * x.abs().sum((1, 2))).sum()
        used = k > 0
        mx = x.abs().amax((1, 2))[used].max()
        mean = float(s1) / cnt
        var = max(float(s2) / cnt - mean * mean, 0.0)
        out[label] = {"n_devices": cnt, "mean_err": mean,
                      "std_err": var ** 0.5, "mean_abs_err": float(sa) / cnt,
                      "worst_abs": float(mx)}
    return out


def _between(v, ts, t_between, dtype) -> torch.Tensor:
    """[D] the integral of the last slab's held readings over
    ``[t0, t1]`` (inside that slab)."""
    t0, t1 = (torch.tensor(x, dtype=torch.float64).to(ts.device, dtype)
              for x in t_between)
    start = ts[:-1]
    stop = ts[1:]
    span = torch.clamp_min(torch.minimum(stop, t1)
                           - torch.maximum(start, t0), 0.0)
    return v[:, :-1] @ span
