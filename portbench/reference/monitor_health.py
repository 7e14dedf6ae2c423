"""The plain reference of the hardened monitor under the source's faults:
what a ``MonitorService(strict_ids=False, health=HealthPolicy(), ...)``
must hold after ``n_slabs`` slabs of a
:class:`~portbench.gen.monitor_health.FaultyTraffic` stream.

The semantics, stated independently of the program.  A sample with an id
outside ``[0, N)`` is rejected; one with a non-finite time or value is
invalid; both are only counted, fleet-wide.  Within a slab a device's
samples are taken in time order; a second copy of a time already seen in
the slab, or of the device's newest accepted time, is a duplicate; a time
older than the newest accepted one is late.  Accepted samples fold in as
the clean monitor's do (:mod:`portbench.reference.monitor`): held
readings integrated raw and corrected, job windows on intervals that
start inside them, run tracking and the period histogram, the label
moments, a ring of each device's newest ``ring_slots`` samples with their
running energies.  After each slab whose newest accepted time ``t_now``
(over the fleet) is at least ``health_every_s`` past the last step's,
each device walks the health machine: silent for more than ``stale`` x
``silent_after_s`` -> stale, for more than ``quarantine`` x it, or
drifting (over twice the drift constant of history, the slab-mean EWMA
off the lifetime mean power by more than ``drift_rel`` of it and
``drift_abs_w``) -> quarantined, counted on entry; clean (reporting, not
stale, not drifting) -> healthy again.  The anomaly rule
(``quarantine_anomalous``: readings outside a power envelope) is left
out: the cell's monitor sets no envelope (``envelope_w`` None), so the
rule never fires there.

The stream is rebuilt from the fault model
(:class:`~portbench.reference.faults.FaultPlan`), not from the slabs sent:
a poll's copies land in its own slab or, held back, in the next, so which
copy is accepted, duplicate or late follows from the copies' draws and
from the newest poll the device kept in its own slab.  The first slabs
(the deaths, then two cycles) are folded origin slab by origin slab
over every device; from there the faults and readings repeat with the
cycle, so each later origin slab adds what the same pool tick added in
the last folded cycle; the last two slabs, the job windows (device by
device, over the slabs around each) and the health machine (slab by slab
over per-device vectors) are worked out at their own times.  ``dtype`` is
the precision of the arithmetic (the control runs it one step lower).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import faults
from portbench.reference.monitor import corrections

F64, I64 = torch.float64, torch.int64
HEALTHY, STALE, QUARANTINED = 0, 1, 2


class _Carry:
    """A device's state between origin slabs: the newest accepted sample
    (``hj`` its poll, ``ho`` its origin slab, -1 none; ``hv``/``hvc`` its
    raw and corrected reading), the last reading change (``cj``/``co``),
    the changes so far, the running energies and the ring."""

    def __init__(self, d: int, slots: int, dtype, dev):
        i = lambda: torch.full((d,), -1, dtype=I64, device=dev)  # noqa
        z = lambda: torch.zeros(d, dtype=dtype, device=dev)       # noqa
        self.hj, self.ho, self.cj, self.co = i(), i(), i(), i()
        self.hv, self.hvc, self.e, self.ec = z(), z(), z(), z()
        self.n_chg = torch.zeros(d, dtype=I64, device=dev)
        self.first_t = torch.full((d,), float("nan"), dtype=dtype,
                                  device=dev)
        self.ring = {k: torch.full((d, slots), fill, dtype=dtype, device=dev)
                     for k, fill in (("t", float("inf")), ("v", 0.0),
                                     ("e", 0.0), ("ec", 0.0))}

    def copy(self) -> "_Carry":
        out = _Carry.__new__(_Carry)
        for k, v in vars(self).items():
            setattr(out, k, ({a: b.clone() for a, b in v.items()}
                             if isinstance(v, dict) else v.clone()))
        return out


class HardenedReference:
    """See the module docstring; :meth:`expected` is the entry."""

    def __init__(self, traffic, n_slabs: int, dtype=F64):
        r = traffic.readings
        self.cfg, self.tr = traffic.config, traffic.traffic
        self.dtype, self.dev = dtype, r.device
        self.d, self.m, self.p = r.n, r.m, r.pool_ticks
        self.n = int(n_slabs)
        self.w = int(self.tr["warmup_slabs"])
        if self.n < self.w + 2:
            raise ValueError("the reference needs the warm-up and two "
                             "slabs more")
        self.slots = int(self.cfg["ring_slots"])
        self.readings = r
        self.plan = faults.FaultPlan(self.cfg, self.tr, traffic.seed,
                                     r.pool_ts)
        corr = corrections(r, dtype)
        self.shift = corr["shift"]
        self.vr = r.pool.to(dtype) - corr["baseline"][None, :, None]
        self.vc = ((self.vr - corr["offset"][None, :, None])
                   / corr["gain"][None, :, None])
        self.win_a, self.win_b = r.win_a.to(dtype), r.win_b.to(dtype)
        flags = [self.plan.flags(q) for q in range(self.p)]
        self.flags = {k: torch.stack([f[k] for f in flags]) for k in flags[0]}
        self.rows = torch.arange(self.d, device=self.dev)
        self.j = torch.arange(self.m, device=self.dev)
        n_bins = int(self.cfg["period_bins"])
        self.edges = torch.tensor(np.geomspace(1e-3, 100.0, n_bins - 1),
                                  dtype=F64).to(self.dev, dtype)
        self.n_bins = n_bins
        # explicit origin slabs: the warm-up and two cycles, then the
        # last two slabs; the origins between repeat the last cycle
        self.e_end = min(self.n - 2, self.w + 2 * self.p)

    # -- the stream, rebuilt ------------------------------------------------
    def _times(self, q, j, c) -> torch.Tensor:
        """Reported times of polls ``j`` of pool ticks ``q`` in cycles
        ``c``, one row a device (as :func:`faults.times` computes them)."""
        pl = self.plan
        base = (pl.skew[:, None]
                + (1.0 + pl.drift)[:, None] * self.readings.pool_ts[q, j])
        return (pl.step[:, None] * c.to(F64) + base).to(self.dtype)

    def _held_time(self, j, o) -> torch.Tensor:
        """[D] the time of poll ``j`` of origin slab ``o`` (a row each)."""
        q = torch.remainder(o, self.p)[:, None]
        c = torch.div(o, self.p, rounding_mode="floor")[:, None]
        return self._times(q, j.clamp_min(0)[:, None], c)[:, 0]

    def _copies(self, o: torch.Tensor):
        """Per device (origin slab ``o`` a row): the accepted polls ``g``
        [D, M], the own ones ``a`` and the held ones accepted in the next
        slab ``f``, and the drops of the row's copies."""
        q = torch.remainder(o, self.p)
        fl = {k: v[q, self.rows] for k, v in self.flags.items()}
        alive = self.plan.alive(o)
        final = (o == self.n - 1)[:, None]
        sent = alive & ~fl["gone"]
        kind = fl["kind"]
        valid = sent & (kind == 0)
        rej = sent & (kind == faults.BAD_ID)
        inv = sent & (kind != 0) & (kind != faults.BAD_ID)
        n0 = (~fl["delay0"]).to(I64) + (fl["dup"] & ~fl["delay1"]).to(I64)
        n1 = (fl["delay0"].to(I64) + (fl["dup"] & fl["delay1"]).to(I64)) \
            * (~final).to(I64)
        a = valid & (n0 >= 1)
        jj = self.j[None, :]
        big_j = torch.where(a, jj, -1).amax(1, keepdim=True)
        f = valid & (n1 >= 1) & (n0 == 0) & (jj > big_j)
        again = valid & (n1 >= 1) & (n0 >= 1)

        def s(x):
            return x.to(I64).sum(1)
        drops = {
            "dup": s(valid & (n0 == 2)) + s(valid & (n1 == 2))
            + s(again & (jj == big_j)),
            "late": s(again & (jj != big_j))
            + s(valid & (n1 >= 1) & (n0 == 0) & (jj <= big_j)),
            "inv": ((n0 + n1) * inv.to(I64)).sum(1),
            "rej": ((n0 + n1) * rej.to(I64)).sum(1)}
        return a | f, a, f, drops

    def _fold(self, o: torch.Tensor, cin: _Carry):
        """Fold origin slab ``o`` (one a device) onto the carried state:
        the rows' sums and the state after."""
        zero = torch.zeros((), dtype=self.dtype, device=self.dev)
        q = torch.remainder(o, self.p)
        c = torch.div(o, self.p, rounding_mode="floor")
        g, a, f, out = self._copies(o)
        jj = self.j[None, :]
        t = self._times(q[:, None], jj, c[:, None])
        v, vc = self.vr[q, self.rows], self.vc[q, self.rows]
        # each accepted sample's predecessor: in the slab, or carried
        last = torch.cummax(torch.where(g, jj, -1), 1).values
        prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
        inside, pi = prev >= 0, prev.clamp_min(0)
        ht = self._held_time(cin.hj, cin.ho)
        pt = torch.where(inside, t.gather(1, pi), ht[:, None])
        pv = torch.where(inside, v.gather(1, pi), cin.hv[:, None])
        pvc = torch.where(inside, vc.gather(1, pi), cin.hvc[:, None])
        has = g & (inside | (cin.hj >= 0)[:, None])
        dt = t - pt
        inc = torch.where(has, pv * dt, zero)
        incc = torch.where(has, pvc * dt, zero)
        out["e"], out["ec"] = inc.sum(1), incc.sum(1)
        out["ec_own"] = torch.where(a, incc, zero).sum(1)
        out["ec_front"] = torch.where(f, incc, zero).sum(1)
        wa, wb = self.win_a[:, None], self.win_b[:, None]
        out["win"] = torch.where(has & (pt >= wa), pv * torch.clamp_min(
            torch.minimum(pt + dt, wb) - pt, 0.0), zero).sum(1)
        pts = pt - self.shift[:, None]
        out["winc"] = torch.where(has & (pts >= wa), pvc * torch.clamp_min(
            torch.minimum(pts + dt, wb) - pts, 0.0), zero).sum(1)
        # run tracking: a change closes the run the change before opened
        chg = has & (v != pv)
        ci = chg.to(I64)
        cl = torch.cummax(torch.where(chg, jj, -1), 1).values
        cprev = torch.cat([torch.full_like(cl[:, :1], -1), cl[:, :-1]], 1)
        ct = self._held_time(cin.cj, cin.co)
        start = torch.where(cprev >= 0, t.gather(1, cprev.clamp_min(0)),
                            ct[:, None])
        rec = chg & (cin.n_chg[:, None] + torch.cumsum(ci, 1) - ci >= 1)
        dur = torch.where(rec, t - start, zero)
        bins = torch.searchsorted(self.edges, dur, right=True)
        key = (self.rows[:, None] * self.n_bins + bins)[rec]
        size = self.d * self.n_bins
        out["hist_n"] = torch.zeros(size, dtype=I64, device=self.dev
                                    ).index_add_(0, key, torch.ones_like(
                                        key)).view(self.d, -1)
        out["hist_s"] = torch.zeros(size, dtype=self.dtype, device=self.dev
                                    ).index_add_(0, key, dur[rec]).view(
                                        self.d, -1)
        out["chg"] = ci.sum(1)
        # counts, label sums and the newest samples the slabs carry
        out["n"] = g.to(I64).sum(1)
        out["cnt_own"], out["cnt_front"] = a.to(I64).sum(1), f.to(
            I64).sum(1)
        out["svc_own"] = torch.where(a, vc, zero).sum(1)
        out["svc_front"] = torch.where(f, vc, zero).sum(1)
        gv = torch.where(g, vc, zero)
        out["m1"], out["m2"], out["ma"] = gv.sum(1), (gv * gv).sum(1), \
            gv.abs().sum(1)
        out["mx"] = gv.abs().amax(1)
        out["j_own"] = torch.where(a, jj, -1).amax(1)
        out["j_front"] = torch.where(f, jj, -1).amax(1)

        cout = cin.copy()
        got = last[:, -1] >= 0
        hj = last[:, -1].clamp_min(0)[:, None]
        cout.hj = torch.where(got, last[:, -1], cin.hj)
        cout.ho = torch.where(got, o, cin.ho)
        cout.hv = torch.where(got, v.gather(1, hj)[:, 0], cin.hv)
        cout.hvc = torch.where(got, vc.gather(1, hj)[:, 0], cin.hvc)
        changed = cl[:, -1] >= 0
        cout.cj = torch.where(changed, cl[:, -1], cin.cj)
        cout.co = torch.where(changed, o, cin.co)
        cout.n_chg = cin.n_chg + out["chg"]
        first = torch.where(g, jj, self.m - 1).amin(1, keepdim=True)
        cout.first_t = torch.where(torch.isnan(cin.first_t) & got,
                                   t.gather(1, first)[:, 0], cin.first_t)
        cout.e, cout.ec = cin.e + out["e"], cin.ec + out["ec"]
        # the ring: the slab's newest samples after the carried ones
        k = self.slots
        newest = torch.topk(torch.where(g, jj, -1), k, 1).values.flip(1)
        ok = newest >= 0
        ni = newest.clamp_min(0)
        fresh = {"t": t, "v": v,
                 "e": cin.e[:, None] + torch.cumsum(inc, 1),
                 "ec": cin.ec[:, None] + torch.cumsum(incc, 1)}
        n_new = ok.sum(1, keepdim=True)
        i = torch.arange(k, device=self.dev)[None, :]
        pick = torch.where(i < k - n_new, n_new + i, k + i)
        for key_, x in fresh.items():
            merged = torch.cat([cin.ring[key_], x.gather(1, ni)], 1)
            cout.ring[key_] = merged.gather(1, pick)
        return out, cout

    # -- the run -------------------------------------------------------------
    def _steady_carry(self, carries: Dict[int, _Carry], o: torch.Tensor
                      ) -> _Carry:
        """The state before origin slab ``o`` (one a device) from the
        folded cycle's: the same pool tick's, its samples' origins moved
        on by whole cycles (the dead devices' stay as they were)."""
        base = self.e_end - self.p
        slot = base + torch.remainder(o - base, self.p)
        out = carries[base].copy()
        for s_ in range(base, self.e_end):
            here = slot == s_
            src = carries[s_]
            for k in ("hj", "ho", "cj", "co", "hv", "hvc"):
                getattr(out, k)[here] = getattr(src, k)[here]
        moved = o - slot
        for k in ("ho", "co"):
            x = getattr(out, k)
            setattr(out, k, torch.where(x >= self.w, x + moved, x))
        return out

    def expected(self) -> dict:
        d, dev, p, n = self.d, self.dev, self.p, self.n
        carry = _Carry(d, self.slots, self.dtype, dev)
        tot: Dict[str, torch.Tensor] = {}
        stats: Dict[int, dict] = {}
        carries: Dict[int, _Carry] = {}

        def add(out, times=1):
            for k, x in out.items():
                if k in ("mx", "j_own", "j_front"):
                    continue
                tot[k] = tot.get(k, 0) + times * x
            if times:
                tot["mx"] = torch.maximum(tot.get("mx", out["mx"]),
                                          out["mx"])

        def fold(o):
            nonlocal carry
            carries[o] = carry
            out, carry = self._fold(torch.full((d,), o, dtype=I64,
                                               device=dev), carry)
            stats[o] = {k: out[k] for k in (
                "j_own", "j_front", "cnt_own", "cnt_front", "svc_own",
                "svc_front", "ec_own", "ec_front")}
            return out

        steady = range(self.e_end, n - 2)
        cycle = {}
        for o in range(self.e_end):
            out = fold(o)
            add(out)
            if o >= self.e_end - p:
                cycle[o % p] = out
        if len(steady):
            for q, out in cycle.items():
                k = sum(1 for o in steady if o % p == q)
                add({x: y for x, y in out.items()
                     if x not in ("win", "winc")}, k)
            carries[self.e_end] = carry
            carry = self._steady_carry(carries, torch.full(
                (d,), n - 2, dtype=I64, device=dev))
            carry.e, carry.ec, carry.n_chg = tot["e"], tot["ec"], tot["chg"]
            carry.first_t = carries[self.e_end].first_t
        for o in (n - 2, n - 1):
            add(fold(o))
        if len(steady):
            win, winc = self._steady_windows(carries)
            tot["win"], tot["winc"] = tot["win"] + win, tot["winc"] + winc
        return self._result(tot, stats, carry)

    def _steady_windows(self, carries: Dict[int, _Carry]):
        """[D] raw and corrected window energy of the origin slabs that
        were not folded: each device's window spans a few slabs, which
        are folded device by device."""
        pl, tick = self.plan, float(self.cfg["tick_s"])
        lo = (self.win_a.to(F64) - pl.skew) / (1.0 + pl.drift)
        hi = (self.win_b.to(F64) + self.shift.to(F64) - pl.skew) / (
            1.0 + pl.drift)
        o0 = torch.floor(lo / tick).to(I64) - 1
        o1 = torch.floor(hi / tick).to(I64) + 1
        win = torch.zeros(self.d, dtype=self.dtype, device=self.dev)
        winc = torch.zeros_like(win)
        first, stop = self.e_end, self.n - 2
        o0 = o0.clamp(first, stop)
        o1 = o1.clamp(first - 1, stop - 1)
        for k in range(int((o1 - o0).max().clamp_min(-1)) + 1):
            o = o0 + k
            live = o <= o1
            o = torch.where(live, o, first)
            out, _ = self._fold(o, self._steady_carry(carries, o))
            win += torch.where(live, out["win"], 0.0)
            winc += torch.where(live, out["winc"], 0.0)
        return win, winc

    def _stats(self, stats: Dict[int, dict], o: int) -> dict:
        if self.e_end <= o < self.n - 2:
            base = self.e_end - self.p
            o = base + (o - base) % self.p
        return stats[o]

    def _health(self, stats: Dict[int, dict], first_t: torch.Tensor):
        """The health machine over the slabs, with the per-device state it
        reads (newest time, energy, the drift EWMA) followed slab by slab."""
        cfg, d, dev, dt_ = self.cfg, self.d, self.dev, self.dtype
        pol = cfg["health"]
        after = float(cfg["silent_after_s"])
        every = float(cfg["health_every_s"])
        tau = float(cfg.get("drift_tau_s", 30.0))
        rel = float(cfg.get("drift_rel", 0.25))
        abs_w = float(cfg.get("drift_abs_w", 5.0))
        zf = lambda: torch.zeros(d, dtype=dt_, device=dev)  # noqa
        has = torch.zeros(d, dtype=torch.bool, device=dev)
        last_t, e_corr, ewma = zf(), zf(), zf()
        code = torch.zeros(d, dtype=torch.int8, device=dev)
        clean_t, clean = zf(), torch.zeros_like(has)
        n_q = torch.zeros(d, dtype=I64, device=dev)
        next_t = -float("inf")
        first = torch.where(torch.isnan(first_t), 0.0, first_t)
        for i in range(self.n):
            own = self._stats(stats, i)
            q_i = torch.full((d,), i, dtype=I64, device=dev)
            t_own = self._held_time(own["j_own"], q_i)
            got = own["j_own"] >= 0
            cnt, svc, de = own["cnt_own"], own["svc_own"], own["ec_own"]
            newest = t_own
            if i:
                fr = self._stats(stats, i - 1)
                t_fr = self._held_time(fr["j_front"], q_i - 1)
                newest = torch.where(got, t_own, t_fr)
                got = got | (fr["j_front"] >= 0)
                cnt, svc = cnt + fr["cnt_front"], svc + fr["svc_front"]
                de = de + fr["ec_front"]
            e_corr = e_corr + de
            mean = svc / cnt.clamp_min(1)
            alpha = torch.exp(-torch.clamp_min(newest - last_t, 0.0) / tau)
            ewma = torch.where(got, torch.where(
                has, alpha * ewma + (1.0 - alpha) * mean, mean), ewma)
            has = has | got
            last_t = torch.where(got, newest, last_t)
            t_now = float(torch.where(got, newest, -float("inf")).max())
            if not (t_now >= next_t):
                continue
            next_t = t_now + every
            silent = t_now - last_t
            stale = has & (silent > float(pol["stale_factor"]) * after)
            dead = has & (silent > float(pol["quarantine_factor"]) * after)
            dur = last_t - first
            mean_p = torch.where(dur > 0.0, e_corr / dur, float("nan"))
            drift = (has & (dur > 2.0 * tau) & torch.isfinite(mean_p)
                     & ((ewma - mean_p).abs()
                        > torch.clamp_min(rel * mean_p.abs(), abs_w)))
            bad = dead | (drift if pol["quarantine_drifting"] else False)
            ok = has & ~stale & ~drift
            clean_t = torch.where(ok & ~clean, t_now, clean_t)
            new = torch.where((code == HEALTHY) & stale & ~bad,
                              STALE, code.to(I64))
            new = torch.where(bad, QUARANTINED, new)
            back = ((code == STALE) & ok & ~bad) | (
                (code == QUARANTINED) & ok & ~bad
                & (t_now - clean_t >= float(pol["recover_after_s"])))
            new = torch.where(back, HEALTHY, new).to(torch.int8)
            n_q = n_q + ((new == QUARANTINED) & (code != QUARANTINED))
            code, clean = new, ok
        return code, n_q

    def _result(self, tot, stats, carry: _Carry) -> dict:
        code, n_q = self._health(stats, carry.first_t)
        has = carry.hj >= 0
        zero = torch.zeros((), dtype=self.dtype, device=self.dev)
        last_t = torch.where(has, self._held_time(carry.hj, carry.ho), zero)
        out = {"energy_j": tot["e"], "energy_corr_j": tot["ec"],
               "win_j": tot["win"], "win_corr_j": tot["winc"],
               "n_changes": tot["chg"], "n_samples": tot["n"],
               "n_dup": tot["dup"], "n_late": tot["late"], "has": has,
               "first_t": torch.where(has, carry.first_t, zero),
               "last_t": last_t, "last_v": torch.where(has, carry.hv, zero),
               "health_code": code, "n_quarantines": n_q,
               "ring": carry.ring}
        out["period_est"] = self._estimates(tot["hist_n"], tot["hist_s"])
        out["moments"] = self._moments(tot)
        counts = [int(x) for x in torch.stack([
            tot["n"].sum(), tot["dup"].sum(), tot["late"].sum(),
            tot["inv"].sum(), tot["rej"].sum(), has.sum(),
            (code == HEALTHY).sum(), (code == STALE).sum(),
            (code == QUARANTINED).sum()]).tolist()]
        out["counters"] = dict(zip(
            ("accepted", "duplicates", "late", "invalid", "rejected",
             "devices_reporting", "n_healthy", "n_stale", "n_quarantined"),
            counts))
        return out

    def _estimates(self, counts, sums) -> torch.Tensor:
        """[D] update-period estimates: the mean run of the median bin;
        nan below ``min_runs`` complete runs."""
        n_runs = counts.sum(1)
        need = (n_runs + 1) // 2
        bstar = (torch.cumsum(counts, 1) >= need[:, None]).to(
            torch.int8).argmax(1)
        cnt = counts.gather(1, bstar[:, None])[:, 0]
        est = sums.gather(1, bstar[:, None])[:, 0] / torch.clamp_min(cnt, 1)
        return torch.where((n_runs >= int(self.cfg["min_runs"])) & (cnt > 0),
                           est, float("nan"))

    def _moments(self, tot) -> Dict[str, Dict[str, float]]:
        """Per label: count, mean, spread, mean magnitude and largest
        magnitude of the accepted corrected readings."""
        names = np.asarray(self.readings.labels)
        out = {}
        for label in sorted(set(self.readings.labels)):
            rows = torch.as_tensor(np.flatnonzero(names == label),
                                   device=self.dev)
            cnt = int(tot["n"][rows].sum())
            if not cnt:
                continue
            s1, s2, sa = (float(tot[k][rows].sum()) for k in ("m1", "m2",
                                                              "ma"))
            mean = s1 / cnt
            out[label] = {"n_devices": cnt, "mean_err": mean,
                          "std_err": max(s2 / cnt - mean * mean, 0.0) ** 0.5,
                          "mean_abs_err": sa / cnt,
                          "worst_abs": float(tot["mx"][rows].max())}
        return out


def expected(traffic, n_slabs: int, dtype=F64) -> dict:
    """The hardened monitor's state after slabs ``0 .. n_slabs - 1`` of
    ``traffic``: every device's counts, times, energies, windows, period
    estimate, health code and quarantines, its ring, the label moments
    and the fleet's counters."""
    # no float32 product of the control may run in TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return HardenedReference(traffic, n_slabs, dtype).expected()
