"""The plain reference of the fleet audit: each sampled device's naive and
§5 energies, worked out from the audit's seed alone.

The audit's users hand it the profile names, the fleet scenario recipe
and a seed; everything else is derived, and so worked out again here,
from a frozen copy of the derivation's definitions: the keyed random
stream (Philox4x32-10, :class:`Keyed`), the four scenario shapes of the
mix, the sensors' hidden gain, offset and phase, the boxcar readings
quantised with their jitter, the naive protocol (one run polled every
``poll_period_s``) and the §5 protocol (repetition trains with phase-shift
gaps, random starts, the rise discarded, readings re-synchronised by the
window).  Every device's answer depends on its fleet row and the seed
alone, so the reference computes only the sampled rows.

``AuditReference(dtype)`` computes in ``dtype``; its control runs it one
step lower.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

I64 = torch.int64
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
TAG_NOISE, TAG_TRIAL, TAG_SCENARIO = 1, 3, 7
_FAR = torch.iinfo(I64).max // 2
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_SQRT_HALF = 0.70710678118654752440

Bank = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _mulhilo(m: int, x):
    p_lo = (x & 0xFFFF) * m
    p_hi = (x >> 16) * m
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK


def philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on 32-bit words held in int64."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


class Keyed:
    """Draws addressed by (key, row, slot, tag) in ``dtype``."""

    def __init__(self, dtype):
        self.f = dtype

    def block(self, key, rows, slots, tag):
        rows = torch.as_tensor(rows, dtype=I64)
        slots = torch.as_tensor(slots, dtype=I64, device=rows.device)
        rows, slots = torch.broadcast_tensors(rows, slots)
        if isinstance(key, torch.Tensor):
            k0, k1 = key & _MASK, (key >> 32) & _MASK
            k0, k1 = k0.to(rows.device), k1.to(rows.device)
        else:
            key = int(key) % (1 << 64)
            k0, k1 = key & _MASK, key >> 32
        return philox(rows, slots, torch.full_like(rows, int(tag)),
                      torch.zeros_like(rows), k0, k1)

    def unit(self, hi, lo):
        return ((hi << 21) | (lo >> 11)).to(self.f) * 2.0 ** -53

    def uniform(self, key, rows, slots, tag):
        x0, x1, _, _ = self.block(key, rows, slots, tag)
        return self.unit(x0, x1)

    def normal(self, key, rows, slots, tag):
        x0, x1, x2, x3 = self.block(key, rows, slots, tag)
        u1, u2 = self.unit(x0, x1), self.unit(x2, x3)
        return torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos(
            (2.0 * math.pi) * u2)


class Streams:
    """A scenario's draws: lane ``i`` under key ``seeds[i]``, slot after
    slot."""

    def __init__(self, keyed: Keyed, seeds: torch.Tensor):
        self.k, self.seeds, self.slot = keyed, seeds, 0

    @property
    def n(self):
        return self.seeds.shape[0]

    def units(self, width):
        dev = self.seeds.device
        slots = torch.arange(self.slot, self.slot + width, device=dev)
        self.slot += width
        return self.k.uniform(self.seeds[:, None],
                              torch.zeros((1, width), dtype=I64, device=dev),
                              slots[None, :], TAG_SCENARIO)

    def uniform(self, lo, hi):
        return lo + (hi - lo) * self.units(1)[:, 0]

    def uniform_block(self, lo, hi, counts, width):
        return torch.where(_live(counts, width),
                           lo + (hi - lo) * self.units(width), 0.0)

    def exponential_block(self, scale, counts, width):
        out = -scale * _log_unit(1.0 - self.units(width))
        return torch.where(_live(counts, width), out, 0.0)

    def poisson(self, lam, cap):
        u = self.units(cap)
        enlam = math.exp(-lam)
        prod = torch.ones(self.n, dtype=u.dtype, device=u.device)
        k = torch.zeros(self.n, dtype=I64, device=u.device)
        for j in range(cap):
            prod = prod * u[:, j]
            k = k + (prod > enlam).to(I64)
        return k


def _live(counts, width):
    return torch.arange(width, device=counts.device)[None, :] < counts[:, None]


def _log_unit(x):
    """ln ``x`` on (0, 1] by frexp and an atanh series."""
    m, e = torch.frexp(x)
    low = m < _SQRT_HALF
    m = torch.where(low, m * 2.0, m)
    e = (e - low.to(e.dtype)).to(x.dtype)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    p = torch.full_like(z, 1.0 / 25.0)
    for k in range(11, -1, -1):
        p = p * z + 1.0 / (2 * k + 1)
    return e * _LN2_HI + (e * _LN2_LO + 2.0 * s * p)


def _cum_edges(durs):
    cols = [torch.zeros(durs.shape[0], dtype=durs.dtype, device=durs.device)]
    for j in range(durs.shape[1]):
        cols.append(cols[-1] + durs[:, j])
    return torch.stack(cols, dim=1)


def _fixed(durs, powers):
    n, s = powers.shape
    return (_cum_edges(durs), powers,
            torch.full((n,), s, dtype=I64, device=powers.device))


# -- the scenario shapes (idle_w, peak_w in watts; windows in seconds) -----
def training(st: Streams, idle_w, peak_w):
    """A compute phase near peak, then a collective at lower draw."""
    compute = st.uniform(0.100, 0.160)
    collective = st.uniform(0.040, 0.080)
    p_hi = peak_w * st.uniform(0.82, 0.95)
    p_lo = peak_w * st.uniform(0.55, 0.70)
    return _fixed(torch.stack([compute, collective], 1),
                  torch.stack([p_hi, p_lo], 1))


def inference(st: Streams, idle_w, peak_w, window_s=0.350, rate_hz=14.0,
              max_bursts=12):
    """Poisson arrivals over the serving window, each a burst of
    exponential length (at least 2 ms) at p_hi; overlapping bursts merge;
    idle between."""
    n, dev, w = st.n, st.seeds.device, max_bursts
    k = st.poisson(rate_hz * window_s, max_bursts)
    p_hi = peak_w * st.uniform(0.75, 0.92)
    arrivals = st.uniform_block(0.0, window_s, k, w)
    arrivals = torch.where(_live(k, w), arrivals, math.inf)
    arrivals = torch.sort(arrivals, dim=1).values
    lengths = torch.clamp_min(st.exponential_block(0.012, k, w), 0.002)
    zero = torch.zeros(n, dtype=p_hi.dtype, device=dev)
    idle = torch.full((n,), idle_w, dtype=p_hi.dtype, device=dev)
    dur, pw, emit = [], [], []
    cursor = busy_until = zero
    for j in range(w):
        live = k > j
        a = torch.where(live, arrivals[:, j], 0.0)
        d = torch.where(live, lengths[:, j], 0.0)
        end = torch.clamp_max(a + d, window_s)
        gap = live & (a > busy_until)
        dur.append(torch.where(gap, a - cursor, 0.0))
        pw.append(idle)
        emit.append(gap)
        cursor = torch.where(gap, a, cursor)
        end = torch.maximum(end, busy_until)
        burst = live & (end > cursor)
        dur.append(torch.where(burst, end - cursor, 0.0))
        pw.append(torch.where(burst, p_hi, idle_w))
        emit.append(burst)
        cursor = torch.where(burst, end, cursor)
        busy_until = torch.where(live, torch.maximum(busy_until, end),
                                 busy_until)
    tail = cursor < window_s
    dur.append(torch.where(tail, window_s - cursor, 0.0))
    pw.append(idle)
    emit.append(tail)
    dur, pw, emit = (torch.stack(x, 1) for x in (dur, pw, emit))
    first = torch.arange(2 * w + 1, device=dev)[None, :] == 0
    none = (k == 0)[:, None]
    emit = torch.where(none, first, emit)
    dur = torch.where(none & first, window_s, dur)
    pw = torch.where(none & first, idle_w, pw)
    n_segs = emit.sum(1)
    smax = int(n_segs.max())
    slots = torch.where(emit, torch.cumsum(emit, 1) - 1, smax)
    out_dur = torch.zeros((n, smax + 1), dtype=dur.dtype, device=dev)
    out_pw = torch.full((n, smax + 1), idle_w, dtype=dur.dtype, device=dev)
    out_dur.scatter_(1, slots, dur)
    out_pw.scatter_(1, slots, pw)
    return _cum_edges(out_dur[:, :smax]), out_pw[:, :smax], n_segs


def idle(st: Streams, idle_w, peak_w, window_s=0.450):
    """An idle floor with one short blip."""
    blip = st.uniform(0.015, 0.035)
    at = st.uniform(0.0, window_s - blip)
    p_blip = idle_w + (peak_w - idle_w) * st.uniform(0.2, 0.4)
    p_floor = idle_w * st.uniform(1.0, 1.15)
    return _fixed(torch.stack([at, blip, (window_s - at) - blip], 1),
                  torch.stack([p_floor, p_blip, p_floor], 1))


def diurnal(st: Streams, idle_w, peak_w, window_s=0.300, n_steps=6):
    """Six equal plateaus along a sine of random phase and depth."""
    phase = st.uniform(0.0, 2.0 * math.pi)
    depth = st.uniform(0.5, 0.9)
    step = (math.pi / 3.0) / (n_steps - 1)
    pts = [i * step for i in range(n_steps)]
    pts[-1] = math.pi / 3.0
    hours = phase[:, None] + torch.tensor(pts, dtype=torch.float64).to(
        phase.device, phase.dtype)[None, :]
    util = 0.5 * (1.0 + torch.sin(hours)) * depth[:, None]
    floor = 0.15 * (peak_w - idle_w)
    amp = idle_w + floor + (peak_w - idle_w - floor) * util
    amp = torch.where(util <= 0.0, idle_w, amp)
    return _fixed(torch.full((st.n, n_steps), window_s / n_steps,
                             dtype=phase.dtype, device=phase.device), amp)


SHAPES = {"training": training, "inference": inference, "idle": idle,
          "diurnal": diurnal}


def mix_labels(n: int, mix: Dict[str, float], seed: int) -> np.ndarray:
    """Each device's scenario: largest-remainder shares of ``mix`` over
    the sorted kinds, shuffled by ``default_rng(seed).permutation``."""
    kinds = sorted(mix)
    total = sum(mix.values())
    exact = np.array([mix[k] / total * n for k in kinds])
    counts = np.floor(exact).astype(int)
    rema = exact - counts
    for i in np.argsort(-rema)[: n - int(counts.sum())]:
        counts[i] += 1
    labels = np.repeat(np.array(kinds), counts)
    return labels[np.random.default_rng(seed).permutation(n)]


def fleet_names(config: dict, n: int) -> List[str]:
    """The fleet's profile of each row.  ``profile_pattern`` repeats a
    list of names row after row (every slab holds the whole mix);
    otherwise ``profiles`` gives contiguous blocks, each share ``floor(n *
    share)`` but the last, which takes the rest."""
    pattern = config.get("profile_pattern")
    if pattern:
        return [pattern[i % len(pattern)] for i in range(n)]
    out: List[str] = []
    shares = config["profiles"]
    for i, (name, share) in enumerate(shares):
        k = (n - len(out)) if i == len(shares) - 1 else int(n * share)
        out += [name] * k
    return out


class AuditReference:
    """The audit's answers for sampled fleet rows, in ``dtype``."""

    def __init__(self, config: dict, dtype=torch.float64, device="cuda"):
        self.cfg = config
        self.f = dtype
        self.dev = torch.device(device)
        self.keyed = Keyed(dtype)

    def t(self, x):
        return torch.as_tensor(x, dtype=self.f, device=self.dev)

    # -- timelines -------------------------------------------------------
    def scenarios(self, seed: int, rows: np.ndarray) -> Tuple[Bank, list]:
        """The sampled rows' workloads: (edges, powers, idle, n_segs)."""
        cfg = self.cfg
        n, mix = int(cfg["n_devices"]), cfg["scenario_mix"]
        idle_w, peak_w = cfg["idle_w"], cfg["peak_w"]
        labels = mix_labels(n, mix, seed)[rows]
        parts = []
        for kind in np.unique(labels):
            sel = np.flatnonzero(labels == kind)
            keys = torch.as_tensor(seed + 1 + rows[sel], dtype=I64,
                                   device=self.dev)
            parts.append((sel, SHAPES[str(kind)](
                Streams(self.keyed, keys), idle_w, peak_w)))
        g = len(rows)
        smax = max(p.shape[1] for _, (_, p, _) in parts)
        edges = torch.zeros((g, smax + 1), dtype=self.f, device=self.dev)
        powers = torch.full((g, smax), idle_w, dtype=self.f, device=self.dev)
        n_segs = torch.empty(g, dtype=I64, device=self.dev)
        for sel, (e, p, ns) in parts:
            s = p.shape[1]
            at = torch.as_tensor(sel, device=self.dev)
            edges[at, :s + 1] = e
            edges[at, s + 1:] = e[:, -1:]
            powers[at, :s] = p
            n_segs[at] = ns
        idle = torch.full((g,), idle_w, dtype=self.f, device=self.dev)
        return self.normal_bank(edges, powers, idle, n_segs), list(labels)

    @staticmethod
    def normal_bank(e, p, idle, ns) -> Bank:
        """Past each row's segments: the last edge repeated, idle power."""
        s = p.shape[1]
        cols = torch.arange(s + 1, device=e.device)[None, :]
        last = torch.gather(e, 1, ns[:, None])
        e = torch.where(cols > ns[:, None], last, e)
        p = torch.where(cols[:, :s] >= ns[:, None], idle[:, None], p)
        return e, p, idle, ns

    def integral(self, bank: Bank, t0, t1):
        """Exact ∫P dt per row over ``[t0, t1]`` ([G] or [G, M]); idle
        outside the row's edges."""
        e, p, idle, ns = bank
        seg = p * torch.diff(e, dim=1)
        cum = torch.cat([torch.zeros((e.shape[0], 1), dtype=self.f,
                                     device=self.dev),
                         torch.cumsum(seg, 1)], 1)
        first, last = e[:, :1], e[:, -1:]
        hi = torch.clamp_min(ns - 1, 0)[:, None]
        flat = t0.ndim == 1

        def at(t):
            t = t[:, None] if flat else t
            tc = torch.minimum(torch.maximum(t, first), last)
            pos = torch.searchsorted(e.contiguous(), tc.contiguous(),
                                     right=True) - 1
            idx = torch.minimum(torch.clamp_min(pos, 0), hi)
            inner = (torch.gather(cum, 1, idx) + torch.gather(p, 1, idx)
                     * (tc - torch.gather(e, 1, idx)))
            return (inner + torch.clamp_max(t - first, 0.0) * idle[:, None]
                    + torch.clamp_min(t - last, 0.0) * idle[:, None])

        out = at(t1) - at(t0)
        return out[:, 0] if flat else out

    # -- the sensors -----------------------------------------------------
    def fleet(self, seed: int, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        """Each sampled row's sensor: its catalog fields and its hidden
        gain, offset and phase, drawn for the whole fleet at once."""
        cfg = self.cfg
        n = int(cfg["n_devices"])
        names = fleet_names(cfg, n)
        uniq = list(dict.fromkeys(names))
        code = torch.tensor([uniq.index(x) for x in names], dtype=I64)

        def table(key):
            return torch.tensor([float(cfg["sensors"][u][key]) for u in uniq],
                                dtype=torch.float64)[code]

        gen = torch.Generator().manual_seed(int(seed))
        u = torch.rand((3, n), generator=gen, dtype=torch.float64)
        period = table("update_period_s")
        hidden = {"gain": 1.0 + (2.0 * u[0] - 1.0) * table("gain_tol"),
                  "offset": (2.0 * u[1] - 1.0) * table("offset_tol_w"),
                  "phase": u[2] * period, "period": period,
                  "window": table("window_s"), "quantum": table("quantum_w"),
                  "noise": table("noise_w")}
        sel = torch.as_tensor(rows)
        out = {k: v[sel].to(self.dev, self.f) for k, v in hidden.items()}
        out["rows"] = torch.as_tensor(rows, dtype=I64, device=self.dev)
        out["names"] = [names[i] for i in rows]
        out["seed"] = int(seed)
        return out

    def sub(self, sensors, idx: np.ndarray):
        at = torch.as_tensor(idx, device=self.dev)
        out = {k: (v[at] if isinstance(v, torch.Tensor) else v)
               for k, v in sensors.items() if k != "names"}
        out["names"] = [sensors["names"][i] for i in idx]
        return out

    def boxcar(self, sensors, bank: Bank, ticks, slots):
        """The readings published at ``ticks`` [G, K]: the mean over the
        trailing window, with gain, offset and the jitter of noise slot
        ``slots``, quantised and floored at 0."""
        w = sensors["window"][:, None]
        raw = self.integral(bank, ticks - w, ticks) / torch.clamp_min(
            ticks - (ticks - w), 1e-12)
        z = self.keyed.normal(sensors["seed"], sensors["rows"][:, None],
                              torch.clamp_min(slots, 0), TAG_NOISE)
        noise = z * sensors["noise"][:, None]
        q = sensors["quantum"][:, None]
        vals = sensors["gain"][:, None] * raw + sensors["offset"][:, None]
        return torch.clamp_min(torch.round((vals + noise) / q) * q, 0.0)

    def readings(self, sensors, bank: Bank, t_end):
        """The published readings: every update period from the sensor's
        phase, the mean over the trailing window, with gain, offset and
        jitter, quantised and floored at 0."""
        T, phase = sensors["period"], sensors["phase"]
        k0 = torch.floor((0.0 - phase) / T).to(I64)
        k1 = torch.ceil((t_end - phase) / T).to(I64)
        m = int((k1 - k0).max()) + 1
        ks = k0[:, None] + torch.arange(m, device=self.dev)[None, :]
        ticks = phase[:, None] + T[:, None] * ks
        valid = (ks <= k1[:, None]) & (ticks >= 0.0 - T[:, None])
        first = valid.to(torch.int8).argmax(1)
        count = valid.sum(1)
        slot = torch.arange(m, device=self.dev)[None, :] - first[:, None]
        vals = torch.where(valid, self.boxcar(sensors, bank, ticks, slot),
                           0.0)
        return {"ticks": ticks, "vals": vals, "first": first,
                "last": first + count - 1, "k0": k0, "phase": phase,
                "T": T}

    def slots_at(self, sch, tq):
        """The reading current at ``tq`` [G, K]: the arithmetic slot,
        settled against the stored ticks, clamped to the valid slots."""
        ticks = sch["ticks"]
        m = ticks.shape[1]
        j = torch.floor((tq - sch["phase"][:, None]) / sch["T"][:, None]).to(
            I64) - sch["k0"][:, None]
        j = torch.clamp(j, 0, m - 1)
        for _ in range(2):
            tj = torch.gather(ticks, 1, j)
            j = torch.where((tj > tq) & (j > 0), j - 1, j)
        for _ in range(2):
            jn = torch.clamp_max(j + 1, m - 1)
            tn = torch.gather(ticks, 1, jn)
            j = torch.where((tn <= tq) & (jn > j), jn, j)
        return torch.minimum(torch.maximum(j, sch["first"][:, None]),
                             sch["last"][:, None])

    def polled(self, sch, t1, period, a, b, offset):
        """∫ of the polled readings over ``[a, b]``: the polls every
        ``period`` from 0 to ``t1`` read the current reading at their true
        instant and report it at the instant plus ``offset``; each
        reported reading holds until the next poll, the last until
        ``b``."""
        g = a.shape[0]
        m_i = torch.floor((t1 - 0.0) / period).to(I64)

        def q(idx):
            return 0.0 + period * idx.to(self.f)

        def r(idx):
            return q(idx) + offset

        j0 = torch.ceil((a - offset - 0.0) / period).to(I64)
        j1 = torch.floor((b - offset - 0.0) / period).to(I64)
        for _ in range(2):
            j0 = torch.where(r(j0 - 1) >= a, j0 - 1, j0)
            j0 = torch.where(r(j0) < a, j0 + 1, j0)
            j1 = torch.where(r(j1 + 1) <= b, j1 + 1, j1)
            j1 = torch.where(r(j1) > b, j1 - 1, j1)
        j0 = torch.clamp_min(j0, 0)
        j1 = torch.minimum(j1, m_i - 1)
        ticks = sch["ticks"]
        m = ticks.shape[1]
        slot = torch.arange(m, device=self.dev)[None, :]
        lo = torch.ceil((ticks - 0.0) / period).to(I64)
        for _ in range(2):
            lo = torch.where(q(lo - 1) >= ticks, lo - 1, lo)
            lo = torch.where(q(lo) < ticks, lo + 1, lo)
        hi = torch.cat([lo[:, 1:] - 1, torch.full((g, 1), _FAR, dtype=I64,
                                                  device=self.dev)], 1)
        lo = torch.where(slot == sch["first"][:, None], 0, lo)
        hi = torch.where(slot == sch["last"][:, None], _FAR, hi)
        counts = (torch.minimum(hi, (j1 - 1)[:, None])
                  - torch.maximum(lo, j0[:, None]) + 1)
        valid = ((slot >= sch["first"][:, None])
                 & (slot <= sch["last"][:, None]))
        counts = torch.where(valid, torch.clamp_min(counts, 0), 0)
        slot_b = self.slots_at(sch, q(j1)[:, None])[:, 0]
        vals = sch["vals"] - 0.0
        total = (vals * counts).sum(1) * period
        vb = torch.gather(vals, 1, slot_b[:, None])[:, 0]
        nonempty = j1 >= j0
        total = total + torch.where(nonempty, vb * (b - r(j1)), 0.0)
        return torch.where(nonempty, total, 0.0)

    # -- the protocols ---------------------------------------------------
    def naive(self, sensors, bank: Bank, start=0.3):
        e, p, idle, ns = bank
        dur = e[:, -1] - e[:, 0]
        shifted = (e + (start - e[:, 0])[:, None], p, idle, ns)
        t_end = shifted[0][:, -1]
        sch = self.readings(sensors, shifted, t_end + 1.0)
        return self.polled(sch, t_end + 0.5, self.cfg["poll_period_s"],
                           self.t(start).expand_as(dur), start + dur,
                           torch.zeros_like(dur))

    def train(self, bank: Bank, reps: np.ndarray, shifts: int, W: float):
        """Each row's repetition train: ``reps`` back-to-back runs, an
        idle gap of ``W`` after every whole group of ``reps // shifts``
        runs but the last."""
        e, p, idle, k = bank
        dev, f = self.dev, self.f
        g, smax = p.shape
        rmax = int(np.max(reps))
        n_reps = torch.as_tensor(np.asarray(reps, dtype=np.int64), device=dev)
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
        off = r.to(f)[None, :] * dur[:, None] + gaps.to(f) * W
        live = r[None, :] < n_reps[:, None]
        n_out = n_reps * k + torch.gather(gaps, 1, (n_reps - 1)[:, None])[:, 0]
        width = int(n_out.max())
        drop = width + 1
        j = torch.arange(smax, device=dev)
        seg = live[:, :, None] & (j[None, None, :] < k[:, None, None])
        at = (r[None, :, None] * k[:, None, None] + j[None, None, :]
              + gaps[:, :, None])
        at = torch.where(seg, at, drop).reshape(g, -1)
        new_gap = torch.cat([torch.zeros((g, 1), dtype=torch.bool,
                                         device=dev),
                             gaps[:, 1:] > gaps[:, :-1]], 1) & live
        at_gap = torch.where(new_gap, r[None, :] * k[:, None] + gaps - 1,
                             drop)
        edges = torch.zeros((g, width + 2), dtype=f, device=dev)
        edges.scatter_(1, at, ((rel[:, None, :smax] + off[:, :, None])
                               + t0[:, None, None]).reshape(g, -1))
        edges.scatter_(1, at_gap, (off - W) + t0[:, None])
        end = torch.gather(off, 1, (n_reps - 1)[:, None])[:, 0]
        edges.scatter_(1, n_out[:, None], ((end + dur) + t0)[:, None])
        powers = idle[:, None].repeat(1, width + 2)
        powers.scatter_(1, at,
                        p[:, None, :].expand(g, rmax, smax).reshape(g, -1))
        return self.normal_bank(edges[:, :width + 1], powers[:, :width],
                                idle, n_out)

    def good_practice(self, sensors, bank: Bank, n_trials: int):
        """§5: per profile, repetition trains with phase-shift gaps, at
        ``n_trials`` random starts; the rise discarded, readings
        re-synchronised by the window, the gaps' idle energy taken out,
        the mean over the kept repetitions and the trials."""
        gp = self.cfg["good_practice"]
        e = bank[0]
        g = e.shape[0]
        dur_all = e[:, -1] - e[:, 0]
        u = self.keyed.uniform(0, sensors["rows"][:, None],
                               torch.arange(n_trials, device=self.dev)[None, :],
                               TAG_TRIAL)
        trials = torch.zeros((g, n_trials), dtype=self.f, device=self.dev)
        names = np.array(sensors["names"])
        for name in sorted(set(names)):
            idx = np.nonzero(names == name)[0]
            at = torch.as_tensor(idx, device=self.dev)
            sub = self.sub(sensors, idx)
            sens = self.cfg["sensors"][name]
            T, Wn = sens["update_period_s"], sens["window_s"]
            W = Wn if Wn else T
            frac = min(1.0, Wn / T) if Wn else 1.0
            shifts = gp["n_phase_shifts"] if frac < 0.999 else 0
            rise = 2.5 * T
            starts = 0.3 + u[at]
            dur_t = dur_all[at]
            dur = dur_t.to("cpu", torch.float64).numpy()
            reps = np.maximum(gp["min_reps"], np.ceil(
                gp["min_total_s"] / np.maximum(dur, 1e-6)).astype(np.int64))
            reps = np.minimum(reps, gp["max_reps"])
            n_skip = np.minimum(np.ceil(rise / np.maximum(dur, 1e-6)).astype(
                np.int64), reps - 1)
            if shifts > 0:
                group = np.maximum(1, reps // shifts)
                gb = np.minimum(n_skip // group, (reps - 1) // group)
                ge = np.minimum(reps // group, (reps - 1) // group)
            else:
                gb = ge = np.zeros(len(idx), dtype=np.int64)
            kept = self.t(reps - n_skip)
            off_begin = self.t(n_skip) * dur_t + self.t(gb) * W
            off_end = self.t(reps) * dur_t + self.t(ge) * W
            gaps = self.t(ge - gb)
            rows_bank = tuple(x[at] for x in bank)
            tb0 = self.train(rows_bank, reps, shifts, W)
            for t in range(n_trials):
                start = starts[:, t]
                te, tp, ti, tn = tb0
                tb = (te + (start - te[:, 0])[:, None], tp, ti, tn)
                sch = self.readings(sub, tb, tb[0][:, -1] + 2.0)
                got = self.polled(sch, tb[0][:, -1] + 1.0,
                                  gp["poll_period_s"], start + off_begin,
                                  start + off_end,
                                  torch.full_like(start, -W))
                got = got - gaps * W * ti
                trials[at, t] = got / kept
        return trials.mean(1)

    def audit(self, seed: int, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        """The sampled rows' ``true_j``, ``naive_j``, ``gp_j`` and the two
        errors against the truth."""
        rows = np.asarray(rows, dtype=np.int64)
        bank, _ = self.scenarios(seed, rows)
        sensors = self.fleet(seed, rows)
        e = bank[0]
        true = self.integral(bank, e[:, 0], e[:, -1])
        naive = self.naive(sensors, bank)
        gp = self.good_practice(sensors, bank,
                                int(self.cfg["good_practice"]["n_trials"]))
        return {"true_j": true, "naive_j": naive, "gp_j": gp,
                "naive_err": (naive - true) / true,
                "gp_err": (gp - true) / true}
