"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
the checkout's ``src/``.  Phases, each of which fails the run:

1. print the card's name and power limit, build both CUDA kernels;
2. hold each kernel against its plain PyTorch version on the card, at
   small adversarial shapes and at the main path's slab shapes, and time
   both;
3. the main path: a 100,000-device fleet (half ``a100``, half
   ``h100_instant``) polled every 1 ms in 0.5 s ticks for 10 s through
   ``replay(grid=True)`` (the ``stream_ingest_grid`` kernel), a second
   monitor taking the first 2 s as permuted flattened slabs through
   ``ingest`` (the ``stream_ingest`` kernel) and matching the first at
   2 s, then a batch of queries through ``MonitorQueryService``; then
   both streams again with their slabs built beforehand, to time ingest
   alone;
4. a small fleet through the port on the card and on the CPU (the plain
   path the CPU tests hold against the JAX package), which must agree.

Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
as the last line.  Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_DEVICES = 100_000
STREAM_S = 10.0
FLAT_S = 2.0
PERIOD_S = 0.001
TICK_S = 0.5
SEED = 0
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and FP64 (non-tensor)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
#: float64 operations per sample (sample_math in csrc/scan.cuh, the
#: scans and the row reductions; a division counts as one)
OPS_PER_SAMPLE = {"stream_ingest": 35, "stream_ingest_grid": 35}
REPLACES = {
    "stream_ingest":
        "src/repro/core/engine_backend/pallas_backend.py:99",
    "stream_ingest_grid":
        "src/repro/core/engine_backend/pallas_backend.py:276",
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------
def flat_case(rng, k, u, *, single=False, big_group=0):
    """A contract-respecting flat slab: grouped, time-sorted, with new
    devices, repeated readings, envelope hits and degenerate windows."""
    if single:
        k = u
        seg = np.arange(u)
    else:
        seg = np.sort(rng.integers(0, u, k))
        if big_group:
            seg = np.sort(np.concatenate([seg, np.full(big_group, u // 2)]))
            k = seg.size
        _, seg = np.unique(seg, return_inverse=True)
    u = int(seg.max()) + 1
    t = np.empty(k)
    for g in range(u):
        m = seg == g
        t[m] = np.cumsum(rng.uniform(1e-4, 0.2, m.sum()))
    v = rng.uniform(60.0, 250.0, k)
    rep = rng.random(k) < 0.35
    v[rep] = np.round(v[rep] / 25.0) * 25.0
    first = np.r_[True, seg[1:] != seg[:-1]]
    start = np.flatnonzero(first)
    end = np.r_[start[1:] - 1, k - 1]
    has = rng.random(u) > 0.3
    prev_t = rng.uniform(-1.0, 0.0, u)
    win_a = rng.uniform(0.0, 2.0, u)
    win_b = np.where(rng.random(u) < 0.2, win_a, rng.uniform(2.0, 5.0, u))
    return [t, v, seg, first, start, end, prev_t,
            np.round(rng.uniform(60.0, 250.0, u) / 25.0) * 25.0, has,
            np.where(has, prev_t, t[start]), rng.integers(0, 4, u),
            rng.uniform(0.95, 1.05, u), rng.uniform(-3.0, 3.0, u),
            rng.uniform(0.0, 0.05, u), win_a, win_b,
            np.where(rng.random(u) < 0.5, np.inf, 0.5),
            np.where(rng.random(u) < 0.5, -np.inf, 70.0),
            np.where(rng.random(u) < 0.5, np.inf, 240.0)]


def grid_case(rng, d, m):
    ts = np.cumsum(rng.uniform(1e-4, 0.1, m)) + 2.0
    v = rng.uniform(60.0, 250.0, (d, m))
    rep = rng.random((d, m)) < 0.4
    v[rep] = np.round(v[rep] / 25.0) * 25.0
    has = rng.random(d) > 0.3
    prev_t = rng.uniform(0.0, 2.0, d)
    win_a = rng.uniform(1.5, 3.0, d)
    return [ts, v, prev_t, rng.uniform(60.0, 250.0, d), has,
            np.where(has, prev_t, ts[0] if m else 0.0),
            rng.integers(0, 4, d), rng.uniform(0.95, 1.05, d),
            rng.uniform(-3.0, 3.0, d), rng.uniform(0.0, 0.05, d), win_a,
            np.where(rng.random(d) < 0.2, win_a,
                     win_a + rng.uniform(0.0, 2.0, d)),
            np.where(rng.random(d) < 0.5, np.inf, 0.05),
            np.where(rng.random(d) < 0.5, -np.inf, 70.0),
            np.where(rng.random(d) < 0.5, np.inf, 240.0)]


def energy_atol(name, args):
    """1e-12 × the slab's Σ|increment|, bounded from above by
    Σ (|v| + |pv| + |offset|) / |gain| · |t - pt| (the kernel sums each
    device alone, the plain version re-bases a slab-wide prefix)."""
    if name == "stream_ingest":
        t, v, seg, first = args[:4]
        pt = torch.where(first, args[6][seg], torch.cat([t[:1] * 0, t[:-1]]))
        pv = torch.where(first, args[7][seg], torch.cat([v[:1] * 0, v[:-1]]))
        g, off = args[11][seg], args[12][seg]
    else:
        ts, v = args[:2]
        d, m = v.shape
        if m == 0:
            return 1e-12
        pt = torch.cat([args[2][:, None], ts[:-1][None, :].expand(d, m - 1)],
                       1)
        pv = torch.cat([args[3][:, None], v[:, :-1]], 1)
        t = ts[None, :]
        g, off = args[7][:, None], args[8][:, None]
    dens = (v.abs() + pv.abs() + off.abs()) / g.abs()
    return 1e-12 * max(float((dens * (t - pt).abs()).sum()), 1.0)


def compare(name, kernel_fn, plain_fn, args, trapezoid):
    """Run both versions on the same card inputs; returns the largest
    absolute error of the float outputs."""
    out_k = kernel_fn(*args, trapezoid)
    out_p = plain_fn(*args, trapezoid)
    torch.cuda.synchronize()
    check(type(out_k) is type(out_p), f"{name}: output kind")
    atol = energy_atol(name, args)
    worst = 0.0
    for f in out_p._fields:
        a, b = getattr(out_k, f), getattr(out_p, f)
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}: {f} is {a.dtype}{tuple(a.shape)}, plain "
              f"{b.dtype}{tuple(b.shape)}")
        if f in out_p.BITWISE or not a.is_floating_point():
            check(torch.equal(a, b), f"{name}: {f} not bitwise equal")
        elif a.numel():
            err = float((a - b).abs().max())
            worst = max(worst, err)
            check(err <= atol + 1e-12 * float(b.abs().max()),
                  f"{name}: {f} off by {err:.3e} (atol {atol:.3e})")
    return worst


def to_card(args, dev):
    return [torch.as_tensor(np.asarray(a), device=dev) for a in args]


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_bytes(name, args, outs):
    """Bytes the kernel must move: each input it reads once, each output
    written once (the flat kernel does not read ``seg``/``first``)."""
    ins = [a for i, a in enumerate(args)
           if not (name == "stream_ingest" and i in (2, 3))]
    return sum(x.numel() * x.element_size() for x in list(ins) + list(outs))


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------
def fleet(dev, n):
    from repro_torch.core.fleet_engine import SensorBank
    from repro_torch.core.ground_truth import from_segments
    names = ["a100"] * (n // 2) + ["h100_instant"] * (n - n // 2)
    # alternating kernel bursts and idle of several lengths (13 ms .. 1 s)
    pattern = [(0.05, 300.0), (0.03, 70.0), (0.2, 280.0), (0.1, 70.0),
               (0.013, 310.0), (0.37, 90.0), (1.0, 250.0), (0.5, 60.0)]
    tl = from_segments(pattern * 6, t0=0.4, idle_w=60.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    shifts = torch.rand(n, generator=gen, dtype=torch.float64,
                        device=dev) * 0.5
    bank = SensorBank.from_catalog(names, seed=SEED, device=dev)
    bank.attach(tl, shifts=shifts)
    return names, tl, shifts, bank


def monitor(dev, names, shifts):
    from repro_torch.core.stream import (MonitorService, StreamCorrections,
                                         default_calibrations)
    mon = MonitorService(
        len(names), device=dev, labels=np.array(names, dtype=object),
        corrections=StreamCorrections.from_calibrations(
            names, default_calibrations(names), device=dev))
    mon.set_windows(1.0 + shifts, 9.0 + shifts)
    return mon


def flat_slabs(bank, t1, dev):
    """The flattened poll slabs over [0, t1), each in a seeded random
    arrival order."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    for d, t, v in bank.iter_poll_slabs(0.0, t1, PERIOD_S, TICK_S,
                                        chunk_devices=bank.n_devices):
        perm = torch.randperm(d.numel(), generator=gen, device=dev)
        yield d[perm], t[perm], v[perm]


def assert_states_match(a, b, label, energy_rtol):
    """``convert.monitor_arrays`` dicts: bitwise where the two paths
    compute the same values, ``energy_rtol`` for reordered sums."""
    check(set(a) == set(b), f"{label}: state keys differ")
    worst = 0.0
    for key in sorted(a):
        x, y = a[key], b[key]
        check(x.shape == y.shape, f"{label}: {key} shape")
        group, field = key.split(".")
        if group == "moments" and x.dtype == np.float64:
            # per-label reading moments: m2 = Σvc² - n·mean² cancels, so
            # reordered sums move it by more than the energies (the
            # reference's own grid-vs-flat pin uses 1e-9)
            ok = np.allclose(x, y, rtol=1e-9, atol=1e-9)
        elif x.dtype == np.float64 and field in (
                "energy_j", "energy_corr_j", "win_j", "win_corr_j",
                "ewma_w", "e_raw", "e_corr", "sums"):
            ok = np.allclose(x, y, rtol=energy_rtol, atol=1e-9,
                             equal_nan=True)
            den = np.maximum(np.abs(y), 1e-9)
            worst = max(worst, float(np.max(np.abs(x - y) / den,
                                            initial=0.0)))
        else:
            ok = np.array_equal(x, y, equal_nan=x.dtype == np.float64)
        check(ok, f"{label}: {key} differs")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build both kernels, one nvcc each, started together --------------
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name in _build.SOURCES:
        path = _build.BUILD_DIR / f"{name}.log"
        if path.exists():
            for line in path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    results = run(dev, N_DEVICES, STREAM_S, FLAT_S)
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev, n_devices, stream_s, flat_s):
    """Phases 2-4 on ``dev`` for an ``n_devices`` fleet; returns the
    kernels' records."""
    from repro_torch import convert
    from repro_torch.core.ground_truth import TimelineBank
    from repro_torch.core.stream import MonitorService, replay
    from repro_torch.core.stream import ingest as ingest_mod
    from repro_torch.engine_backend import torch_backend as tb
    from repro_torch.kernels import _build
    from repro_torch.kernels.stream_ingest import stream_ingest
    from repro_torch.kernels.stream_ingest_grid import stream_ingest_grid
    from repro_torch.serve.monitor_service import (MonitorQuery,
                                                   MonitorQueryService)

    kernels = {"stream_ingest": (stream_ingest, tb.stream_ingest),
               "stream_ingest_grid": (stream_ingest_grid,
                                      tb.stream_ingest_grid)}

    # -- 2a. small adversarial shapes ----------------------------------------
    rng = np.random.default_rng(SEED)
    cases = []
    for trap in (False, True):
        cases += [("stream_ingest", flat_case(rng, 8, 8, single=True), trap),
                  ("stream_ingest", flat_case(rng, 300, 7), trap),
                  ("stream_ingest", flat_case(rng, 2000, 40, big_group=5000),
                   trap),
                  ("stream_ingest", flat_case(rng, 129, 1), trap)]
        for d, m in ((1, 1), (7, 31), (33, 32), (300, 33), (64, 500),
                     (5, 0)):
            cases.append(("stream_ingest_grid", grid_case(rng, d, m), trap))
    small_err = {k: 0.0 for k in kernels}
    for name, args, trap in cases:
        k_fn, p_fn = kernels[name]
        small_err[name] = max(small_err[name],
                              compare(name, k_fn, p_fn, to_card(args, dev),
                                      trap))
    log(f"kernels vs plain, {len(cases)} small adversarial cases: "
        + " ".join(f"{k} max_abs_err={v:.3e}" for k, v in small_err.items()))

    # -- 2b. the main path's slab shapes: capture the kernels' inputs from
    # the second slab of each path on a fresh fleet, then compare and time
    names, tl, shifts, bank = fleet(dev, n_devices)
    captured = {}

    def recording(key, fn):
        def rec(*args):
            captured[key] = args
            return fn(*args)
        return rec

    ingest_mod.stream_ingest = recording("stream_ingest", stream_ingest)
    ingest_mod.stream_ingest_grid = recording("stream_ingest_grid",
                                              stream_ingest_grid)
    try:
        cap = monitor(dev, names, shifts)
        replay(bank, cap, 0.0, 2 * TICK_S, PERIOD_S, TICK_S,
               chunk_devices=n_devices, grid=True)
        cap = monitor(dev, names, shifts)
        for d, t, v in flat_slabs(bank, 2 * TICK_S, dev):
            cap.ingest(d, t, v)
        del cap
    finally:
        ingest_mod.stream_ingest = stream_ingest
        ingest_mod.stream_ingest_grid = stream_ingest_grid

    results = {}
    for name, (k_fn, p_fn) in kernels.items():
        args = list(captured[name][:-1])
        trap = captured[name][-1]
        err = compare(name, k_fn, p_fn, args, trap)
        outs = k_fn(*args, trap)
        ms = time_ms(lambda: k_fn(*args, trap), 20)
        plain_ms = time_ms(lambda: p_fn(*args, trap), 3)
        samples = args[1].numel()
        nbytes = kernel_bytes(name, args, outs)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = samples * OPS_PER_SAMPLE[name] / FP64_OPS_PER_S * 1e3
        shape = ([samples, int(args[6].numel())] if name == "stream_ingest"
                 else list(args[1].shape))
        results[name] = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{_build.SOURCES[name]}",
            replaces=REPLACES[name], launches=0,
            max_abs_err=max(err, small_err[name]), ms=ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None, shape=shape, bytes=nbytes,
            gb_per_s=nbytes / (ms * 1e-3) / 1e9)
        log(f"{name} at {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {max(bytes_ms, ops_ms):.3f} ms, max_abs_err "
            f"{err:.3e}")
        del outs, args
    captured.clear()
    torch.cuda.empty_cache()

    # -- 3a. main path: grid replay of the whole stream ----------------------
    mon = monitor(dev, names, shifts)
    at_flat_end = {}

    def progress(m, t_emitted):
        if not at_flat_end and t_emitted >= flat_s - PERIOD_S - 1e-9:
            at_flat_end.update(convert.monitor_arrays(m))
            at_flat_end["counters"] = m.counters

    stream_ingest_grid.launches = 0
    stream_ingest.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counters = replay(bank, mon, 0.0, stream_s, PERIOD_S, TICK_S,
                      chunk_devices=n_devices, grid=True, progress=progress)
    torch.cuda.synchronize()
    grid_secs = time.perf_counter() - t0
    results["stream_ingest_grid"]["launches"] = stream_ingest_grid.launches
    check(stream_ingest_grid.launches > 0, "grid path ran no grid kernel")
    check(stream_ingest.launches == 0, "clean grid stream fell back")
    n_samples = n_devices * int(round(stream_s / PERIOD_S))
    check(counters["accepted"] == n_samples,
          f"grid path accepted {counters['accepted']} of {n_samples}")
    log(f"grid path: {n_samples} samples in {grid_secs:.2f} s "
        f"({n_samples / grid_secs / 1e6:.1f} M samples/s incl. the sensor "
        f"source), {stream_ingest_grid.launches} kernel launches")

    # -- 3b. main path: the flattened, permuted first flat_s seconds ---------
    flat = monitor(dev, names, shifts)
    stream_ingest_grid.launches = 0
    stream_ingest.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d, t, v in flat_slabs(bank, flat_s, dev):
        flat.ingest(d, t, v)
    torch.cuda.synchronize()
    flat_secs = time.perf_counter() - t0
    results["stream_ingest"]["launches"] = stream_ingest.launches
    check(stream_ingest.launches > 0, "flat path ran no flat kernel")
    check(stream_ingest_grid.launches == 0, "flat path ran the grid kernel")
    n_flat = n_devices * int(round(flat_s / PERIOD_S))
    log(f"flat path: {n_flat} permuted samples in {flat_secs:.2f} s "
        f"({n_flat / flat_secs / 1e6:.1f} M samples/s incl. the source), "
        f"{stream_ingest.launches} kernel launches")
    check(at_flat_end.pop("counters") == flat.counters,
          "grid and flat monitors count differently at 2 s")
    flat_counters, flat_state = flat.counters, convert.monitor_arrays(flat)
    worst = assert_states_match(at_flat_end, flat_state,
                                "grid vs flat at 2 s", 1e-11)
    log(f"grid and flat monitors match at {flat_s} s (largest relative "
        f"energy difference {worst:.3e})")
    del at_flat_end, flat
    torch.cuda.empty_cache()

    # -- 3c. queries -----------------------------------------------------------
    svc = MonitorQueryService(mon)
    t_end = stream_s - PERIOD_S
    queries = [MonitorQuery.fleet_energy(None),
               MonitorQuery.fleet_energy(t_end - 0.002),
               MonitorQuery.fleet_energy(t_end - 0.002, corrected=False),
               MonitorQuery.window_energy(None),
               MonitorQuery.window_energy(t_end, corrected=False),
               MonitorQuery.energy_between(t_end - 0.006, t_end - 0.001),
               MonitorQuery.by_label(),
               MonitorQuery.by_label(t_end - 0.006, t_end - 0.001),
               MonitorQuery.fleet_energy(None)]
    t0 = time.perf_counter()
    answers = svc.query_many(queries)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    fe, fe_t, fe_raw, win, win_raw, (eb, eb_cov), lab, lab_w, fe2 = answers
    check(fe2 is fe, "duplicate query not served from the batch")
    for x in (fe, fe_t, fe_raw):
        check(x.per_device_j.shape == (n_devices,)
              and bool(x.covered.all())
              and bool(torch.isfinite(x.per_device_j).all())
              and math.isfinite(x.total_j) and x.total_j > 0,
              "fleet_energy answer malformed")
    check(bool(eb_cov.all()) and bool(torch.isfinite(eb).all()),
          "energy_between not covered by the ring")
    check(set(lab) == {"a100", "h100_instant"}
          and all(d["n_covered"] == n_devices // 2 for d in lab_w.values()),
          "by_label answer malformed")
    check(bool(torch.isfinite(win).all()) and bool(
        torch.isfinite(win_raw).all()), "window energy not finite")
    log(f"query batch of {len(queries)}: {q_s * 1e3:.1f} ms, fleet "
        f"{fe.total_j / 3.6e6:.3f} kWh corrected, {fe_raw.total_j / 3.6e6:.3f}"
        f" kWh raw at t={t_end - 0.002}")

    # information, not a gate: §5 naive and corrected windows vs the truth
    a, b = 1.0 + shifts, 9.0 + shifts
    truth = TimelineBank.from_timeline(tl, n_devices, shifts,
                                       device=dev).integral(a, b)
    naive = mon.window_energy(corrected=False)
    corr = mon.window_energy(corrected=True)
    log("window energy vs ground truth: naive mean rel err "
        f"{float(((naive - truth) / truth).mean()):+.4%}, corrected "
        f"{float(((corr - truth) / truth).mean()):+.4%} "
        f"(|err| p99 naive {float(((naive - truth) / truth).abs().quantile(0.99)):.4%}, "
        f"corrected {float(((corr - truth) / truth).abs().quantile(0.99)):.4%})")
    del svc, answers

    # -- 3d. ingest alone: the same two streams, with every slab built
    # (and permuted) before the clock starts, so neither the sensor
    # source nor the arrival permutation is timed; each monitor must end
    # where its main-path twin did
    def ingest_alone(slabs, grid, label, n, want_counters, want_state):
        for run_no in (1, 2):
            m = monitor(dev, names, shifts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for d, t, v in slabs:
                if grid:
                    m.ingest_grid(d, t, v)
                else:
                    m.ingest(d, t, v)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            log(f"{label} ingest alone, run {run_no}: {n} samples in "
                f"{secs:.6f} s ({n / secs / 1e6:.3f} M samples/s, "
                f"{secs / len(slabs) * 1e3:.3f} ms per slab)")
        check(m.counters == want_counters, f"{label} ingest alone counts "
              "differently from the main path")
        assert_states_match(convert.monitor_arrays(m), want_state,
                            f"{label} ingest alone vs main path", 1e-12)

    slabs = list(bank.iter_poll_slabs(0.0, stream_s, PERIOD_S, TICK_S,
                                      chunk_devices=n_devices, grid=True))
    ingest_alone(slabs, True, "grid", n_samples, counters,
                 convert.monitor_arrays(mon))
    slabs = list(flat_slabs(bank, flat_s, dev))
    ingest_alone(slabs, False, "flat", n_flat, flat_counters, flat_state)
    del mon, bank, slabs, flat_state

    # -- 4. a small fleet on the card against the plain path on the CPU ------
    for grid in (True, False):
        states = []
        for d in (dev, torch.device("cpu")):
            names_s, _, shifts_s, bank_s = fleet(dev, 64)
            m = MonitorService(
                64, device=d, labels=np.array(names_s, dtype=object),
                ring_slots=8, envelope_w=(0.0, 400.0))
            m.set_windows((1.0 + shifts_s).to(d), (3.0 + shifts_s).to(d))
            for dd, t, v in bank_s.iter_poll_slabs(0.0, 3.2, PERIOD_S,
                                                   TICK_S, grid=grid):
                if grid:
                    m.ingest_grid(dd.to(d), t.to(d), v.to(d))
                else:
                    m.ingest(dd.to(d), t.to(d), v.to(d))
            states.append((m.counters, convert.monitor_arrays(m)))
        check(states[0][0] == states[1][0],
              f"small fleet grid={grid}: counters differ card vs CPU")
        worst = assert_states_match(states[0][1], states[1][1],
                                    f"small fleet grid={grid}", 1e-12)
        log(f"small fleet grid={grid}: card matches the CPU plain path "
            f"(largest relative energy difference {worst:.3e})")

    return list(results.values())


if __name__ == "__main__":
    sys.exit(main())
