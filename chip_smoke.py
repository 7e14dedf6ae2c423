"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and
the checkout's ``src/``.  Phases, each of which fails the run:

1. print the card's name and power limit, build the eight CUDA sources
   of the seven kernels (``flash_attention`` has two routes; one ``nvcc``
   each, started together) and print their registers and spills;
2. hold the monitor's two kernels against their plain PyTorch versions on
   the card, at small adversarial shapes (among them the grid kernel's
   128-column tile edges and odd M on odd D, so that every other row is
   off 16-byte alignment) and at the main path's slab shapes, time both,
   and log the grid kernel's registers, shared memory and residency;
3. the live monitor's main path: a 100,000-device fleet (half ``a100``,
   half ``h100_instant``) polled every 1 ms in 0.5 s ticks for 10 s
   through ``replay(grid=True)`` (the ``stream_ingest_grid`` kernel), a
   second monitor taking the first 2 s as permuted flattened slabs
   through ``ingest`` (the ``stream_ingest`` kernel) and matching the
   first at 2 s, then a batch of queries through ``MonitorQueryService``;
   then both streams again with their slabs built beforehand, to time
   ingest alone;
4. a small fleet through the monitor on the card and on the CPU (the
   plain path the CPU tests hold against the JAX package), which must
   agree; then phase 9 (below) on phase 3's fleet;
5. the batched fleet audit's main path: ``log_filter`` against its plain
   version at small adversarial shapes and at each route's edges (G not
   a multiple of the tile's rows, G = 1, zero-width padding, S where a
   tile drops to one row and past it on the two-launch route, ticks far
   before, on and past the edges), each on the route ``plan`` gives; a
   96-device audit on the card and on the CPU, which must agree; then
   ``fleet_audit`` over 100,000 devices of every transient kind (Fig.
   14) with the naive and §5 protocols, every ``log_filter`` launch on
   the shared-memory route (launches by route and tile rows logged), its
   per-profile errors, its streamed moments against the exact ones, and
   ``log_filter`` held against its plain version and timed at the
   largest shape the audit gave it, its bound from the f64 instructions
   of the built kernel's SASS;
6. the scalar §5 path: ``step_integrate`` against its plain version at
   adversarial rows (a trial's M = 7440 with windows at both ends, empty
   and reversed, times repeated across the kernel's pivots, M = 1, M
   around each block size), at a real §5 trial's [1, M] and at [4096,
   8192], timed at the last two beside an empty launch of the same grid
   (``launch_floor_ms``); ``benchmarks/energy_cases.py``'s Figs. 15-17
   grid (3 sensor classes × 3 loads × 4 seeds, naive and §5) through
   ``measure_naive`` and ``measure_good_practice`` on the card (the main
   path, whose ``step_integrate`` launches are counted) and on the CPU,
   which must agree per run; 8 devices of the audit's kinds, batched
   protocols against ``scalar_reference(i)`` on the card and on the CPU,
   which must agree, and ``log_filter`` held against its plain version at
   the tick shapes the Kepler/Maxwell scalar sensors gave it (launches of
   both kernels counted over that run alone); ``compare_protocols`` on
   the a100 burst over 5 seeds, §5 beating naive;
7. the paper's load and its §4 black-box characterisation: ``fma_chain``
   against its plain version bitwise (the reference's cases, adversarial
   values, block_rows 128/256/512, and x [SM count × 256, 128] at niter
   4096); Fig. 5 on the card (time against niter 256-4096, R² > 0.97; the
   time at fraction 1.0 at most 1.5× that at 0.2, so one slot is one SM);
   the card's own nvidia-smi polled every 1 ms under an 8 s ``fma_chain``
   square wave and 2 s plateaus at each fraction (information: the poll
   interval achieved, the update period the port's
   ``microbench.complete_run_durations`` gives, the Fig. 8 plateaus); then
   ``characterise`` of simulated a100 (with a ``GroundTruthMeter``), v100
   and rtx3090_average sensors, the Kepler transient (``log_filter``) and
   four update periods on the card and on the CPU, which must agree and
   meet the reference tests' bars; a ``CalibrationStore`` record written
   and reloaded, and a calibrated §5 measurement (``step_integrate``) no
   worse than an uncalibrated one.  Launches: ``fma_chain`` over 7b-7c,
   ``log_filter`` over 7d, ``step_integrate`` over 7e;
8. recurrentgemma-9b serving: ``rglru_scan`` against its plain version
   bitwise and ``flash_attention`` against ``blocked_attention`` within
   ``FLASH_TOL`` of each type, at small adversarial shapes (ragged,
   window, soft-cap, MQA/GQA, odd groups and head_dim, rows with no
   valid key, a last block of 3 positions) in f32, f16 and bf16 and the
   main path's shapes, every 16-bit case on the tensor-core route and
   f32 on the CUDA cores, then a 16-bit head_dim of 40 on the CUDA
   cores; the main shape within a relative L2 of ``FLASH_MAIN_REL_L2``
   too, and timed beside ``scaled_dot_product_attention`` and the
   CUDA-core kernel (8a); then
   the full model
   (38 layers, bf16, weights drawn on the card): ``prefill`` of 2 × 3000
   tokens (past the 2048-token window), 16 greedy ``decode_step``s and a
   2-slot ``ServingEngine`` answering 4 requests, launches counted over
   that run (one per rglru and per attention layer of the prefill, every
   attention launch on the tensor cores),
   then ``prefill(2999) + decode_step`` against ``prefill(3000)`` (8b);
   the reduced model in float32 on the card and the CPU, which must
   agree (8c);
9. the resilient monitor, run right after phase 4 on phase 3's
   100,000-device fleet: 6 s of grid slabs into a monitor with
   ``HealthPolicy()`` and an envelope, a seeded 10% of the devices
   silent from 2 s (half of them back at 4.5 s) and 1% reading outside
   the envelope; at every slab the health codes, counters, flags,
   ``fleet_energy`` and ``by_label`` quarantine counts must be what the
   policy's thresholds imply, and health tracking must leave every
   accumulator bitwise a health-off twin's (ms per slab on and off, the
   health step alone by CUDA events) (9a); the monitor checkpointed at a
   slab boundary synchronously and asynchronously (bytes, seconds, the
   time the asynchronous save blocks), restored on the card and resumed
   bitwise, restored on the CPU and matching the card after one slab
   (9b); ``MonitorSupervisor`` through one injected crash, bitwise the
   uninterrupted run (9c); ``grow`` by 1,000 devices mid-stream, bitwise
   a monitor built at full width from the start (9d).  Its kernel
   launches are logged on their own line;
10. the monitor's sources, right after phase 9 on phase 3's fleet: 2 s
   of flat [100000, 500] slabs through ``replay(faults=...)`` with every
   fault of the bank at once into a ``strict_ids=False`` monitor, whose
   counters must add up to what the ``InjectionLog`` implies; a second
   replay bitwise the first; ``MonitorSupervisor`` through one crash, fed
   by the port's injector, bitwise the uninterrupted replay; the same
   faults over 1,000 devices on the card and the CPU, which must agree
   (ms a slab for injection and ingest, 10a); ``stream_fleet`` over
   100,000 devices against the offline ``integrate_polled`` and
   ``fleet_audit``'s naive energies at 1e-11 (10b); a
   ``SimulatedSampler`` polling the fleet 500 times into a
   ``CollectorPipeline`` with active ``ArtifactStore`` records for 1% of
   the devices, bitwise a flat ``replay`` of the same bank (host ms a
   poll for the sampler, registry and assembler, 10c); the card's own
   nvidia-smi at ``-lms 1`` for ~3 s under an ``fma_chain`` square wave,
   replayed by ``python -m repro_torch.collect`` on the card (a
   subprocess, and in process to count its launches) and on the CPU,
   which must agree (10d).

Prints a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``
as the last line.  Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from datetime import datetime

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
#: f64 instructions a second: the FP64 rate above counts an FMA as two
#: operations, and the pipe issues one f64 instruction a lane a clock
FP64_INSTR_PER_S = FP64_OPS_PER_S / 2
#: what counts as an f64 instruction in SASS: the FP64 pipe's opcodes,
#: the MUFU's 64-bit reciprocal and rsqrt seeds, conversions from or to f64
F64_OPCODE = ("DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX",
              "MUFU.RCP64H", "MUFU.RSQ64H")
#: the audit: 99,000 devices in six equal shares (every transient kind of
#: Fig. 14) and 1,000 module-scope GH200 sensors, in 25,000-device slabs
AUDIT_KINDS = ("a100", "h100_instant", "v100", "kepler", "maxwell", "fermi2")
AUDIT_DEVICES = 100_000
AUDIT_MODULE = 1_000
AUDIT_CHUNK = 25_000
AUDIT_TRIALS = 2
REPLACES = {
    "stream_ingest":
        "src/repro/core/engine_backend/pallas_backend.py:99",
    "stream_ingest_grid":
        "src/repro/core/engine_backend/pallas_backend.py:276",
    "log_filter": "src/repro/core/engine_backend/pallas_backend.py:497",
    "step_integrate":
        "src/repro/core/engine_backend/pallas_backend.py:424",
    "fma_chain": "src/repro/kernels/fma_chain.py:26",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:22",
    "flash_attention": "src/repro/kernels/flash_attention.py:25",
}
#: step_integrate's float64 operations per selected sample (mask select,
#: sub, mul, add; the trapezoid rule's add and half counted too)
STEP_OPS_PER_SAMPLE = 6
STEP_WIDE = (4096, 8192)
#: benchmarks/energy_cases.py (Figs. 15-17): case, profile, window, rise
ENERGY_CASES = (("case1_100_100", "rtx3090_instant", 0.100, 0.25),
                ("case2_1000_100", "rtx3090_average", 1.000, 1.25),
                ("case3_25_100", "a100", 0.025, 0.25))
ENERGY_LOADS = (("short", 0.025), ("medium", 0.100), ("long", 0.800))
ENERGY_SEEDS = 4
#: H100 SXM FP32 (non-tensor) peak, NVIDIA data sheet
FP32_OPS_PER_S = 67e12
#: the paper's load (Fig. 5, benchmarks/load_linearity.py's iteration
#: counts): x [SM count * 256, 128] float32, one grid slot per SM
FMA_BLOCK_ROWS = 256
FMA_NITERS = (256, 512, 1024, 2048, 4096)
FMA_FRACTIONS = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
FMA_REFERENCE_CASES = ((256, 3, 1.0), (512, 10, 0.5), (1024, 1, 0.25),
                       (256, 0, 1.0))
FMA_ADVERSARIAL = (1e-8, -1e-8, 3e-39, -3e-39, 2e38, -2e38, math.inf,
                   -math.inf, math.nan, 1.0, -1.0)
#: 7c: an 8 s square wave of 10 ms on, 10 ms asleep, then 2 s plateaus
SMI_WAVE_S = 8.0
SMI_HALF_S = 0.010
SMI_PLATEAU_S = 2.0
#: phase 8, recurrentgemma-9b at full width and depth, bf16: a prefill of
#: 2 prompts of 3000 tokens (past the 2048-token window, so the rings
#: wrap) into a cache of 3100 positions, then 16 greedy decode steps; a
#: ServingEngine of 2 slots answering 4 requests of 16-token prompts
LM_ARCH = "recurrentgemma-9b"
LM_BATCH = 2
LM_PROMPT = 3000
LM_MAX_SEQ = 3100
LM_DECODE = 16
LM_SERVE_SLOTS = 2
LM_SERVE_REQUESTS = 4
LM_SERVE_PROMPT = 16
LM_SERVE_NEW = 8
LM_SERVE_MAX_SEQ = 64
LM_WINDOW = 2048
#: the kernels' main-path shapes: the recurrence's a, u [B, S, d_rec] and
#: attention's (B, S, Hq, Hkv, head_dim)
LM_SCAN_SHAPE = (LM_BATCH, LM_PROMPT, 4096)
LM_ATTN_SHAPE = (LM_BATCH, LM_PROMPT, 16, 1, 256)
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12
#: flash_attention against blocked_attention, absolute and relative, by
#: type: f32 and bf16 the reference's own flash tests' tolerances
#: (tests/test_kernels.py), f16 between them (its 10-bit mantissa); the
#: two differ in the order of the f32 sums and where a probability
#: rounds to the input type
FLASH_TOL = {torch.float32: 2e-5, torch.float16: 4e-3, torch.bfloat16: 2e-2}
#: relative L2 difference from blocked_attention at the main shape, beside
#: the elementwise bar (a typical output there is ~0.03, near bf16's bar)
FLASH_MAIN_REL_L2 = 1e-2
#: 8b: prefill(S-1) + decode_step against prefill(S), relative L2 of the
#: last position's logits: the two paths round the bf16 residual stream
#: (8 bits of mantissa) at other places over 38 layers
LM_CONSISTENCY_REL = 0.1
#: 8c: card against CPU in float32, relative to the largest logit: the
#: order of f32 sums in the products and in attention
LM_REDUCED_TOL = 1e-4
#: phase 9, the resilient monitor on the monitor phase's fleet: 6 s of
#: grid slabs; from 2 s a seeded 10% of the devices silent and 1% reading
#: outside the envelope, half of the silent back at 4.5 s; the health
#: machine at most every 0.5 s; checkpoints of the monitor after slab 7
#: (4 s), the supervisor checkpointing every 4 slabs and crashing at slab
#: 6, grow by 1,000 devices at 3 s
RES_STREAM_S = 6.0
RES_FAULT_AT_S = 2.0
RES_RETURN_AT_S = 4.5
RES_ANOMALY_W = 5000.0
RES_ENVELOPE_W = (0.0, 1000.0)
RES_HEALTH_EVERY_S = 0.5
RES_SAVE_AFTER = 7
RES_CHECKPOINT_EVERY = 4
RES_CRASH_AT = 6
RES_GROW_AT_S = 3.0
RES_GROW_BY = 1000
RES_CKPT_DIR = os.path.join(ROOT, "build", "chip_ckpt")
#: phase 10, the monitor's sources on the monitor phase's fleet: 2 s of
#: flat slabs ([100000, 500] before the faults) through every fault of the
#: bank at once; the supervisor checkpointing every 2 slabs and crashing
#: at slab 2; the same replay over 1,000 devices on the card and the CPU;
#: stream_fleet over the fleet's profiles; the collector polling the bank
#: 500 times with active store records for 1% of the devices; ~3 s of the
#: card's own nvidia-smi at -lms 1 under an fma_chain square wave
SRC_STREAM_S = 2.0
SRC_SPEC = dict(shuffle=True, dup_fraction=0.05, drop_fraction=0.05,
                delay_fraction=0.05, clock_drift=1e-5, clock_skew_s=1e-3,
                restart_every_s=0.7, restart_blackout_s=0.05,
                corrupt_fraction=1e-4, dropout_fraction=0.01, seed=SEED + 11)
SRC_CHECKPOINT_EVERY = 2
SRC_CRASH_AT = 2
SRC_SMALL = 1000
SRC_POLLS = 500
SRC_STORE_SHARE = 0.01
#: the store's clock: records fitted an hour before it
SRC_NOW = 1.7e9
SRC_SMI_S = 3.0
SRC_DIR = os.path.join(ROOT, "build", "chip_sources")
#: 7d: estimate_update_period's sensor classes and their periods
#: (tests/test_microbench.py::test_update_period_catalog)
CHAR_PERIODS = (("a100", 0.100), ("v100", 0.020), ("turing", 0.100),
                ("rtx3090_instant", 0.100))


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
    """Device milliseconds per call of ``fn``: CUDA events around ``reps``
    calls, enqueued behind a ~0.1 s device-side sleep so that the card
    runs them back to back (a small kernel's wrapper takes longer on the
    host than the kernel on the card; without the sleep its time would
    be the host's)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
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


def monitor(dev, names, shifts, **kw):
    from repro_torch.core.stream import (MonitorService, StreamCorrections,
                                         default_calibrations)
    mon = MonitorService(
        len(names), device=dev, labels=np.array(names, dtype=object),
        corrections=StreamCorrections.from_calibrations(
            names, default_calibrations(names), device=dev), **kw)
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


def states_within_increment(a, b, label):
    """Two ``convert.monitor_arrays`` dicts of monitors fed the same
    stream on the card and the CPU: the energies (state and ring) within
    1e-12 × the stream's Σ|increment|, which is Σ ``energy_j`` + Σ
    ``energy_corr_j`` for readings that are never negative (the plain
    version sums a slab-wide prefix, so its rounding scales with the
    slab, not the device); everything else as ``assert_states_match``.
    Returns the largest energy difference over that bound's scale."""
    scale = float(np.abs(b["state.energy_j"]).sum()
                  + np.abs(b["state.energy_corr_j"]).sum())
    energy = {"energy_j", "energy_corr_j", "win_j", "win_corr_j", "e_raw",
              "e_corr"}
    worst, bad = 0.0, []
    for key in sorted(a):
        x, y = a[key], b[key]
        if key.split(".")[1] in energy:
            d = float(np.max(np.abs(x - y), initial=0.0)) / scale
            worst = max(worst, d)
            if not d <= 1e-12:
                bad.append(f"{key} {d:.3e}")
    check(not bad, f"{label}: beyond 1e-12 x the stream's sum of |increment| "
          f"({scale:.6e} J): {bad}")
    rest = [k for k in a if k.split(".")[1] not in energy]
    assert_states_match({k: a[k] for k in rest}, {k: b[k] for k in rest},
                        label, 1e-12)
    return worst, scale


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

    # -- 1. build the kernels, one nvcc each, started together ---------------
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

    results, fma_10d = run(dev, N_DEVICES, STREAM_S, FLAT_S)
    torch.cuda.empty_cache()
    results.append(audit(dev))
    torch.cuda.empty_cache()
    step, lf_6c = scalar_path(dev)
    results[-1].update(lf_6c)
    results.append(step)
    torch.cuda.empty_cache()
    fma, lf_7d, step_7e = paper_load(dev)
    fma.update(fma_10d)
    results[-2].update(lf_7d)
    results[-1].update(step_7e)
    results.append(fma)
    torch.cuda.empty_cache()
    results.extend(lm_serving(dev))
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev, n_devices, stream_s, flat_s):
    """Phases 2-4 on ``dev`` for an ``n_devices`` fleet; returns the
    monitor kernels' records."""
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
        # from (1, 127) on: the grid kernel's 128-column tiles at their
        # edges, and odd M on odd D (every other row off 16-byte alignment)
        for d, m in ((1, 1), (7, 31), (33, 32), (300, 33), (64, 500),
                     (5, 0), (1, 127), (9, 128), (9, 129), (1, 255),
                     (9, 256), (9, 257), (257, 511), (9, 2049), (257, 255)):
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
        if name == "stream_ingest_grid":
            # the instance the main path runs (the template's bool is
            # trapezoid), its registers and how it fills the card
            from repro_torch.kernels.stream_ingest_grid import launch_config
            cfg = launch_config(shape[0], dev, trap)
            results[name].update(**cfg)
            warps = cfg["blocks_per_sm"] * cfg["threads"] // 32
            log(f"{name}: {cfg['registers']} registers and "
                f"{cfg['local_bytes']} B of local memory a thread, "
                f"{cfg['smem_bytes']} B of shared memory and "
                f"{cfg['threads']} threads a block, {cfg['blocks_per_sm']} "
                f"resident blocks an SM ({warps} warps), grid "
                f"{cfg['grid_blocks']} blocks over "
                f"{cfg['sms']} SMs; {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
                f"{max(bytes_ms, ops_ms) / ms:.1%} of the bound")
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
    injected = counters.pop("injected")
    check(not any(injected.values()), f"clean replay injected {injected}")
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
    del mon, slabs, flat_state

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

    torch.cuda.empty_cache()
    resilient(dev, names, shifts, bank)
    torch.cuda.empty_cache()
    added = sources(dev, names, shifts, bank)
    for name in ("stream_ingest", "stream_ingest_grid"):
        results[name].update(added[name])
    return list(results.values()), added["fma_chain"]


# ---------------------------------------------------------------------------
# the resilient monitor
# ---------------------------------------------------------------------------
def health_monitor(dev, names, shifts, *, health=True, tail=0):
    """Phase 3's monitor with an envelope and, with ``health``, the health
    machine; ``tail`` appends devices as ``grow`` would (identity
    corrections, label "grown", windows disabled, no envelope)."""
    from repro_torch.core.stream import (HealthPolicy, MonitorService,
                                         StreamCorrections,
                                         default_calibrations)
    n = len(names)
    corr = StreamCorrections.from_calibrations(
        names, default_calibrations(names), device=dev)
    labels = np.array(names, dtype=object)
    lo = torch.full((n,), RES_ENVELOPE_W[0], dtype=torch.float64, device=dev)
    hi = torch.full((n,), RES_ENVELOPE_W[1], dtype=torch.float64, device=dev)
    a, b = 1.0 + shifts, 9.0 + shifts
    if tail:
        pad = StreamCorrections.identity(tail, device=dev)
        corr = StreamCorrections(**{
            k: torch.cat([getattr(corr, k), getattr(pad, k)])
            for k in corr.__dataclass_fields__})
        labels = np.concatenate([labels, np.full(tail, "grown", dtype=object)])

        def cat(x, fill):
            return torch.cat([x, torch.full((tail,), fill, dtype=x.dtype,
                                            device=dev)])
        lo, hi = cat(lo, -math.inf), cat(hi, math.inf)
        a, b = cat(a, math.inf), cat(b, -math.inf)
    mon = MonitorService(
        n + tail, device=dev, labels=labels, corrections=corr,
        envelope_w=(lo, hi), health=HealthPolicy() if health else None,
        health_every_s=RES_HEALTH_EVERY_S)
    mon.set_windows(a, b)
    return mon


def resilience_slabs(bank, dev):
    """Phase 9's stream: the monitor phase's grid slabs over
    [0, RES_STREAM_S), with a seeded 10% of the devices left out of the
    rows from RES_FAULT_AT_S, half of those back from RES_RETURN_AT_S,
    and a seeded 1% (disjoint) reading RES_ANOMALY_W from RES_FAULT_AT_S.
    Also returns, per slab, rows 0..RES_GROW_BY-1's clean readings (the
    grown devices' from RES_GROW_AT_S) and the masks."""
    n = bank.n_devices
    gen = torch.Generator()
    gen.manual_seed(SEED + 9)
    perm = torch.randperm(n, generator=gen)
    n_silent, n_anom = n // 10, n // 100
    silent = torch.zeros(n, dtype=torch.bool)
    silent[perm[:n_silent]] = True
    back = torch.zeros(n, dtype=torch.bool)
    back[perm[:n_silent][torch.randperm(n_silent, generator=gen)[
        :n_silent // 2]]] = True
    anom = torch.zeros(n, dtype=torch.bool)
    anom[perm[n_silent:n_silent + n_anom]] = True
    silent, back, anom = silent.to(dev), back.to(dev), anom.to(dev)
    slabs = []
    for ids, ts, vals in bank.iter_poll_slabs(
            0.0, RES_STREAM_S, PERIOD_S, TICK_S, chunk_devices=n, grid=True):
        t0 = float(ts[0])
        tail = (vals[:RES_GROW_BY].clone() if t0 >= RES_GROW_AT_S - 1e-9
                else None)
        if t0 >= RES_FAULT_AT_S - 1e-9:
            vals[anom] = RES_ANOMALY_W
            gone = silent & ~back if t0 >= RES_RETURN_AT_S - 1e-9 else silent
            ids, vals = ids[~gone], vals[~gone]
        slabs.append((ids, ts, vals, tail))
    return slabs, silent, back, anom


def res_fingerprint(mon, t_end):
    """Every query family, the counters and the health summary near the
    stream's end (tests/test_resilience.py's ``_fingerprint`` at instants
    inside the ring), as host arrays."""
    def host(x):
        return (x.cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x))
    fe = mon.fleet_energy(t=t_end - 0.002)
    eb = mon.energy_between(t_end - 0.006, t_end - 0.001)
    out = {
        "fleet_per_device": fe.per_device_j, "fleet_covered": fe.covered,
        "fleet_total": fe.total_j, "fleet_coverage": fe.coverage,
        "fleet_n_q": fe.n_quarantined,
        "fleet_sig": (fe.sigma_independent_j, fe.sigma_worstcase_j),
        "fleet_latest": mon.fleet_energy().per_device_j,
        "between_e": eb[0], "between_cov": eb[1],
        "window": mon.window_energy(t=t_end),
        "periods": mon.update_period_s(),
        **{f"by_label.{k}.{m}": v for k, d in mon.by_label().items()
           for m, v in d.items()},
        **{f"flags.{k}": v for k, v in mon.flags(t=t_end).items()},
        **{f"counters.{k}": v for k, v in mon.counters.items()},
        **{f"health.{k}": v for k, v in mon.health_summary().items()},
    }
    return {k: host(v) for k, v in out.items()}


def fingerprints_equal(a, b, label, skip=()):
    check(set(a) == set(b), f"{label}: query families differ")
    for k in a:
        if k in skip:
            continue
        x, y = a[k], b[k]
        check(x.shape == y.shape and np.array_equal(
            x, y, equal_nan=x.dtype.kind == "f"), f"{label}: {k} differs")


def arrays_equal(a, b, label, skip_moments=False):
    """Two ``convert.monitor_arrays`` dicts, bitwise (the label moments
    aside with ``skip_moments``: on the card they add in no fixed order)."""
    check(set(a) == set(b), f"{label}: state keys differ")
    for key in a:
        if skip_moments and key.startswith("moments."):
            continue
        check(a[key].dtype == b[key].dtype
              and np.array_equal(a[key], b[key],
                                 equal_nan=a[key].dtype.kind == "f"),
              f"{label}: {key} differs")


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def resilient(dev, names, shifts, bank):
    """Phase 9: health, checkpoints, the supervisor and ``grow`` at the
    monitor phase's full width."""
    from repro_torch import convert
    from repro_torch.core.stream import (HEALTHY, QUARANTINED, STALE,
                                         HealthTracker, MonitorSupervisor,
                                         restore_monitor, save_monitor)
    from repro_torch.core.stream.schema import HEALTH_FIELDS
    from repro_torch.kernels.stream_ingest import stream_ingest
    from repro_torch.kernels.stream_ingest_grid import stream_ingest_grid

    shutil.rmtree(RES_CKPT_DIR, ignore_errors=True)
    os.makedirs(RES_CKPT_DIR)
    n = len(names)
    t_phase = time.perf_counter()
    slabs, silent, back, anom = resilience_slabs(bank, dev)
    label_code = torch.tensor([0 if x == "a100" else 1 for x in names],
                              device=dev)
    log(f"9: {len(slabs)} slabs of [{n}, {slabs[0][1].numel()}]; "
        f"{int(silent.sum())} devices silent from {RES_FAULT_AT_S} s, "
        f"{int(back.sum())} of them back from {RES_RETURN_AT_S} s, "
        f"{int(anom.sum())} reading {RES_ANOMALY_W} W from "
        f"{RES_FAULT_AT_S} s (envelope {RES_ENVELOPE_W} W); slabs built in "
        f"{time.perf_counter() - t_phase:.1f} s")
    stream_ingest_grid.launches = 0
    stream_ingest.launches = 0

    # -- 9a. health at full width: the codes the policy implies at each
    # evaluation, health on against off over the same slabs ---------------
    mon = health_monitor(dev, names, shifts)
    off = health_monitor(dev, names, shifts, health=False)
    on_ms, off_ms = [], []
    expect = torch.zeros(n, dtype=torch.int8, device=dev)
    t_last_silent = None
    evals = []
    saved = {}
    for k, (rows, ts, vals, _) in enumerate(slabs):
        t_e = float(ts[-1])
        before = mon.core._next_health_t
        evaluated = False
        for m, times in ((off, off_ms), (mon, on_ms)) if k % 2 else (
                (mon, on_ms), (off, off_ms)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.ingest_grid(rows, ts, vals)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if float(ts[0]) < RES_FAULT_AT_S - 1e-9:
            t_last_silent = t_e
        if mon.core._next_health_t != before:
            evaluated = True
            # an evaluation at t_e: stale past 1x, quarantined past 3x the
            # silent threshold (5x the period estimate, else the
            # calibration's), anomalous devices quarantined, returned
            # devices healthy again (recover_after_s = 0)
            est = mon.update_period_s()
            after = 5.0 * torch.where(torch.isfinite(est), est,
                                      mon.corrections.ref_period_s)
            expect = torch.zeros_like(expect)
            if float(ts[0]) >= RES_FAULT_AT_S - 1e-9:
                gone = (silent & ~back
                        if float(ts[0]) >= RES_RETURN_AT_S - 1e-9 else silent)
                silent_for = t_e - t_last_silent
                quar = (gone & (silent_for > 3.0 * after)) | anom
                stale = gone & ~quar & (silent_for > 1.0 * after)
                expect[stale] = STALE
                expect[quar] = QUARANTINED
                th = after[silent]
                evals.append((t_e, float(th.min()), float(th.median()),
                              float(th.max())))
        check(torch.equal(mon.health.code, expect),
              f"9a: health codes at {t_e} s differ from the policy's")
        want = [int((expect == c).sum()) for c in (HEALTHY, STALE,
                                                   QUARANTINED)]
        c = mon.counters
        check([c["n_healthy"], c["n_stale"], c["n_quarantined"]] == want,
              f"9a: counters at {t_e} s: {c}, expected {want}")
        fe = mon.fleet_energy()
        check(fe.n_quarantined == want[2]
              and fe.coverage == (n - want[2]) / n,
              f"9a: fleet_energy at {t_e} s: n_quarantined "
              f"{fe.n_quarantined}, coverage {fe.coverage}")
        by_q = torch.bincount(label_code[expect == QUARANTINED],
                              minlength=2).tolist()
        bl = mon.by_label()
        check([bl[x]["n_quarantined"] for x in ("a100", "h100_instant")]
              == by_q, f"9a: by_label quarantine at {t_e} s")
        fl = mon.flags(t=t_e)
        check(torch.equal(fl["stale"], expect == STALE)
              and torch.equal(fl["quarantined"], expect == QUARANTINED),
              f"9a: flags at {t_e} s")
        tag = " (evaluated)" if evaluated else ""
        log(f"9a t={t_e:.3f} s{tag}: healthy {want[0]}, stale {want[1]}, "
            f"quarantined {want[2]} (by label {by_q}), coverage "
            f"{fe.coverage:.4f}, "
            f"{c['devices_reporting']} reporting; slab {on_ms[-1]:.3f} ms "
            f"health on, {off_ms[-1]:.3f} ms off")

        if k == RES_SAVE_AFTER:
            # -- 9b. save this slab boundary, synchronously and not -------
            saved["arrays"] = convert.monitor_arrays(mon)
            saved["counters"] = mon.counters
            t0 = time.perf_counter()
            save_monitor(mon, os.path.join(RES_CKPT_DIR, "sync"), step=k)
            saved["sync_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            saved["mgr"] = save_monitor(
                mon, os.path.join(RES_CKPT_DIR, "async"), step=k,
                asynchronous=True)
            saved["block_s"] = time.perf_counter() - t0
    check(any(t >= RES_RETURN_AT_S for t, *_ in evals),
          "9a: no evaluation after the silent devices returned")
    for t_e, lo, med, hi in evals:
        log(f"9a silent threshold at {t_e:.3f} s: min {lo:.4f} s, median "
            f"{med:.4f} s, max {hi:.4f} s (stale past 1x, quarantined "
            f"past 3x)")
    a_on, a_off = convert.monitor_arrays(mon), convert.monitor_arrays(off)
    arrays_equal(a_off, {k: v for k, v in a_on.items()
                         if not k.startswith("health.")},
                 "9a health on vs off", skip_moments=True)
    # the health step alone, on a copy of the machine
    ht = HealthTracker(*(getattr(mon.health, f).clone()
                         for f in HEALTH_FIELDS))
    core = mon.core
    step_kw = dict(t_now=float(slabs[-1][1][-1]), policy=core.health_policy,
                   period_est=core.periods.estimates(),
                   ref_period_s=core.corrections.ref_period_s,
                   silent_after_s=core.silent_after_s,
                   drift_tau_s=core.drift_tau_s, drift_rel=core.drift_rel,
                   drift_abs_w=core.drift_abs_w)
    step_ms = time_ms(lambda: ht.update(core.state, **step_kw), 50)
    est_ms = time_ms(lambda: core.periods.estimates(), 50)
    med_on, med_off = float(np.median(on_ms)), float(np.median(off_ms))
    log(f"9a ms per slab, {len(slabs)} slabs: health on median "
        f"{med_on:.3f} (min {min(on_ms):.3f}, max {max(on_ms):.3f}), off "
        f"median {med_off:.3f} (min {min(off_ms):.3f}, max "
        f"{max(off_ms):.3f}); the health step alone {step_ms:.4f} ms on "
        f"the card (CUDA events, {n} devices), the period estimates it "
        f"reads {est_ms:.4f} ms")
    want_fp = res_fingerprint(mon, float(slabs[-1][1][-1]))
    del off, a_on, a_off, ht

    # -- 9b. checkpoints: bytes, save and restore seconds, bitwise resume
    # on the card, card -> CPU ------------------------------------------------
    t0 = time.perf_counter()
    saved["mgr"].wait()
    wait_s = time.perf_counter() - t0
    sync_dir = os.path.join(RES_CKPT_DIR, "sync", f"step_{RES_SAVE_AFTER}")
    nbytes = dir_bytes(sync_dir)
    check(nbytes == dir_bytes(os.path.join(
        RES_CKPT_DIR, "async", f"step_{RES_SAVE_AFTER}")),
        "9b: the two checkpoints differ in size")
    log(f"9b checkpoint at slab {RES_SAVE_AFTER}: {nbytes} bytes on disk "
        f"({nbytes / n:.1f} B a device, {len(os.listdir(sync_dir))} files); "
        f"synchronous save {saved['sync_s']:.3f} s; asynchronous save "
        f"blocked ingestion {saved['block_s']:.3f} s (the writer drained "
        f"{wait_s:.3f} s after the stream's end)")
    rest = slabs[RES_SAVE_AFTER + 1:]
    restored = {}
    for key, name, where in (("card", "sync", dev), ("async", "async", dev),
                             ("cpu", "sync", torch.device("cpu"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = restore_monitor(os.path.join(RES_CKPT_DIR, name), device=where)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(r.counters == saved["counters"],
              f"9b: {name} restored on {where.type}: counters")
        arrays_equal(convert.monitor_arrays(r), saved["arrays"],
                     f"9b {name} restored on {where.type}")
        log(f"9b restore of the {name} checkpoint on {where.type}: "
            f"{secs:.3f} s, state bitwise the saved monitor's")
        restored[key] = r
    card, cpu = restored["card"], restored["cpu"]
    rows, ts, vals, _ = rest[0]
    t0 = time.perf_counter()
    cpu.ingest_grid(rows.cpu(), ts.cpu(), vals.cpu())
    cpu_s = time.perf_counter() - t0
    card.ingest_grid(rows, ts, vals)
    check(cpu.counters == card.counters, "9b: card and CPU count differently")
    check(torch.equal(cpu.health.code, card.health.code.cpu()),
          "9b: card and CPU health codes differ")
    worst = assert_states_match(convert.monitor_arrays(card),
                                convert.monitor_arrays(cpu),
                                "9b card vs CPU after one slab", 1e-12)
    log(f"9b the CPU restore took the next slab in {cpu_s:.2f} s (plain "
        f"path) and matches the card's (largest relative energy "
        f"difference {worst:.3e})")
    del cpu, restored
    for rows, ts, vals, _ in rest[1:]:
        card.ingest_grid(rows, ts, vals)
    fingerprints_equal(res_fingerprint(card, float(slabs[-1][1][-1])),
                       want_fp, "9b resumed on the card")
    check(torch.equal(card.health.code, mon.health.code),
          "9b: resumed health codes differ")
    log(f"9b resumed on the card after {len(rest)} slabs: every query "
        f"family, the counters and the health codes bitwise the "
        f"uninterrupted monitor's")
    del card

    # -- 9c. the supervisor: one crash mid-stream ---------------------------
    crashed = {"left": 1}

    def source():
        for seq, (rows, ts, vals, _) in enumerate(slabs):
            if crashed["left"] and seq == RES_CRASH_AT:
                crashed["left"] = 0
                raise RuntimeError("collector died")
            yield seq, rows, ts, vals

    sup = MonitorSupervisor(lambda: health_monitor(dev, names, shifts),
                            os.path.join(RES_CKPT_DIR, "supervised"),
                            checkpoint_every=RES_CHECKPOINT_EVERY,
                            device=dev)
    starts = []
    start = sup.start

    def timed_start(*a):
        t0 = time.perf_counter()
        out = start(*a)
        torch.cuda.synchronize()
        starts.append((time.perf_counter() - t0, sup._seq_done))
        return out

    sup.start = timed_start
    t0 = time.perf_counter()
    report = sup.run(source, grid=True)
    torch.cuda.synchronize()
    sup_s = time.perf_counter() - t0
    check(report.n_crashes == 1 and report.n_restores == 1,
          f"9c: {report}")
    fingerprints_equal(res_fingerprint(sup.monitor, float(slabs[-1][1][-1])),
                       want_fp, "9c supervised")
    check(torch.equal(sup.monitor.health.code, mon.health.code),
          "9c: supervised health codes differ")
    log(f"9c supervisor, checkpoint every {RES_CHECKPOINT_EVERY} slabs, "
        f"crash at slab {RES_CRASH_AT}: {report.n_slabs} slabs folded, "
        f"{report.n_skipped} skipped, {report.n_checkpoints} checkpoints, "
        f"{report.n_crashes} crash, {report.n_restores} restore; recovery "
        f"(restore to the checkpoint after slab {starts[-1][1]}) "
        f"{starts[-1][0]:.3f} s, the whole run {sup_s:.2f} s; bitwise the "
        f"uninterrupted monitor's")
    del sup

    # -- 9d. grow mid-stream against the full width from the start ----------
    grown = health_monitor(dev, names, shifts)
    upfront = health_monitor(dev, names, shifts, tail=RES_GROW_BY)
    t_grow = None
    for rows, ts, vals, tail in slabs:
        if tail is not None:
            if grown.n_devices == n:
                epoch = grown.epoch
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grown.grow(n + RES_GROW_BY,
                           labels=np.full(RES_GROW_BY, "grown", dtype=object))
                torch.cuda.synchronize()
                t_grow = time.perf_counter() - t0
                check(grown.epoch == epoch + 1,
                      "9d: grow bumps the epoch once")
            rows = torch.cat([rows, n + torch.arange(RES_GROW_BY, device=dev)])
            vals = torch.cat([vals, tail])
        for m in (grown, upfront):
            m.ingest_grid(rows, ts, vals)
    a, b = (res_fingerprint(m, float(slabs[-1][1][-1]))
            for m in (grown, upfront))
    fingerprints_equal(a, b, "9d grown vs up-front", skip=("health.epoch",))
    arrays_equal(convert.monitor_arrays(grown),
                 convert.monitor_arrays(upfront), "9d grown vs up-front",
                 skip_moments=True)
    check(bool(grown.state.has[n:].all()), "9d: grown devices not reporting")
    log(f"9d grow {n} -> {n + RES_GROW_BY} at {RES_GROW_AT_S} s in "
        f"{t_grow * 1e3:.2f} ms: every query family and state tensor "
        f"(the label moments aside: they add in no fixed order on the "
        f"card) bitwise a monitor built at {n + RES_GROW_BY}")
    log(f"9: kernel launches in phase 9: stream_ingest_grid "
        f"{stream_ingest_grid.launches}, stream_ingest "
        f"{stream_ingest.launches}; phase 9 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    check(stream_ingest_grid.launches > 0, "9: no grid kernel launch")
    del mon, grown, upfront, slabs
    shutil.rmtree(RES_CKPT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# the monitor's sources
# ---------------------------------------------------------------------------
def timed_method(obj, name, times):
    """Wrap ``obj.name`` so that each call appends its milliseconds,
    between two device syncs, to ``times``."""
    raw = getattr(obj, name)

    def call(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = raw(*a, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    setattr(obj, name, call)


def ms_stats(times):
    return (f"median {float(np.median(times)):.3f} (min {min(times):.3f}, "
            f"max {max(times):.3f})")


def faulted_slabs(bank, n, injector_cls, spec):
    """The supervisor's slab source: a fresh injector each call over the
    monitor phase's flat slabs, the held tail as one more slab."""
    def source():
        inj = injector_cls(spec, n, 0.0, SRC_STREAM_S, device=bank.device)
        seq = -1
        for seq, (d, t, v) in enumerate(bank.iter_poll_slabs(
                0.0, SRC_STREAM_S, PERIOD_S, TICK_S, chunk_devices=n)):
            d, t, v = inj.apply(seq, d, t, v)
            if d.numel():
                yield seq, d, t, v
        held = inj.flush()
        if held[0].numel():
            yield (seq + 1, *held)
    return source


def sources(dev, names, shifts, bank):
    """Phase 10: the fault bank, ``stream_fleet``, the collector and the
    card's own nvidia-smi log through ``python -m repro_torch.collect``;
    returns what it adds to the stream_ingest, stream_ingest_grid and
    fma_chain records."""
    import contextlib
    import dataclasses
    import importlib
    import io
    from repro_torch import convert
    from repro_torch.collect import CollectorPipeline, SimulatedSampler, cli
    from repro_torch.collect import wire
    from repro_torch.core import profiles
    from repro_torch.core.calibrate import nominal_record
    from repro_torch.core.calibrate_store import ArtifactStore
    from repro_torch.core.fleet_engine import fleet_audit
    from repro_torch.core.stream import (FaultSpec, MonitorService,
                                         MonitorSupervisor,
                                         StreamCorrections, replay,
                                         stream_fleet)
    from repro_torch.kernels.fma_chain import fma_chain
    from repro_torch.kernels.stream_ingest import stream_ingest
    from repro_torch.kernels.stream_ingest_grid import stream_ingest_grid
    replay_mod = importlib.import_module("repro_torch.core.stream.replay")

    shutil.rmtree(SRC_DIR, ignore_errors=True)
    os.makedirs(SRC_DIR)
    n = len(names)
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    spec = FaultSpec(**SRC_SPEC)
    out = {"stream_ingest": {}, "stream_ingest_grid": {}, "fma_chain": {}}

    # -- 10a. every fault at once at full width ------------------------------
    injectors, inj_ms = [], []
    injector_cls = replay_mod.FaultInjector

    class Logged(injector_cls):
        """The port's injector, kept and timed."""
        n_flushed = 0

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            injectors.append(self)

        def apply(self, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slab = super().apply(*a)
            torch.cuda.synchronize()
            inj_ms.append((time.perf_counter() - t0) * 1e3)
            return slab

        def flush(self):
            held = super().flush()
            self.n_flushed = int(held[0].numel())
            return held

    replay_mod.FaultInjector = Logged
    try:
        runs = []
        for run_no in (1, 2):
            mon = monitor(dev, names, shifts, strict_ids=False)
            ing_ms = []
            timed_method(mon, "ingest", ing_ms)
            n_inj = len(inj_ms)
            stream_ingest.launches = 0
            stream_ingest_grid.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = replay(bank, mon, 0.0, SRC_STREAM_S, PERIOD_S, TICK_S,
                         chunk_devices=n, faults=spec)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(stream_ingest.launches > 0 and
                  stream_ingest_grid.launches == 0,
                  f"10a: launches flat {stream_ingest.launches}, grid "
                  f"{stream_ingest_grid.launches}")
            runs.append(dict(mon=mon, rep=rep, inj=injectors[-1],
                             inj_ms=inj_ms[n_inj:], ing_ms=ing_ms,
                             wall=wall, launches=stream_ingest.launches))
            log(f"10a run {run_no}: {len(ing_ms)} slabs in {wall:.2f} s; "
                f"ms a slab: injection {ms_stats(inj_ms[n_inj:])}, ingest "
                f"{ms_stats(ing_ms)}; {stream_ingest.launches} "
                f"stream_ingest launches")
        first, second = runs
        inj = first["inj"]
        c = inj.log.counts
        k = first["mon"].counters
        n_in = sum(r["in"] for r in inj.log.slabs)
        n_out = sum(r["out"] for r in inj.log.slabs) + inj.n_flushed
        corrupt = c["corrupt_value"] + c["corrupt_id"] + c["corrupt_time"]
        check(n_in == n * int(round(SRC_STREAM_S / PERIOD_S)),
              f"10a: {n_in} samples went into the injector")
        check(all(v > 0 for v in c.values()), f"10a: a fault never fired: {c}")
        check(first["rep"]["injected"] == c, "10a: injected counts differ "
              "from the injector's log")
        check(n_out == n_in - c["dropped_out"] - c["blacked_out"]
              - c["dropped"] + c["duplicated"],
              f"10a: {n_out} samples out of the injector, its log implies "
              f"otherwise ({c})")
        check(k["accepted"] + k["duplicates"] + k["late"] + k["invalid"]
              + k["rejected"] == n_out,
              f"10a: the monitor's counters {k} do not add up to the "
              f"{n_out} samples emitted")
        check(c["corrupt_id"] <= k["rejected"]
              and c["corrupt_value"] + c["corrupt_time"] <= k["invalid"]
              and k["rejected"] + k["invalid"] <= corrupt + c["duplicated"],
              f"10a: rejected/invalid {k} against corrupt {c}")
        check(k["devices_reporting"] == n, "10a: a device never reported")
        log(f"10a: {n_in} samples in, {n_out} out ({inj.n_flushed} flushed "
            f"at the end); injected {c}; restarts at "
            f"{[round(float(r), 4) for r in inj.log.restarts]}; "
            f"{int(np.isfinite(inj.log.dropout_t).sum())} devices die; "
            f"monitor {k}: every identity holds")
        # a second replay with the same spec, bitwise the first
        check(second["rep"] == first["rep"], "10a: the replays count "
              "differently")
        check(second["inj"].log.slabs == inj.log.slabs,
              "10a: the two injection logs differ")
        arrays_equal(convert.monitor_arrays(second["mon"]),
                     convert.monitor_arrays(first["mon"]),
                     "10a second replay", skip_moments=True)
        log("10a: a second replay with the same spec is bitwise the first "
            "(the label moments aside: they add in no fixed order on the "
            "card)")
        want = convert.monitor_arrays(first["mon"])
        want_counters = k
        del second, runs

        # the supervisor through one crash, fed by the port's injector
        crashed = {"left": 1}
        source = faulted_slabs(bank, n, injector_cls, spec)

        def crashing():
            for seq, d, t, v in source():
                if crashed["left"] and seq == SRC_CRASH_AT:
                    crashed["left"] = 0
                    raise RuntimeError("collector died")
                yield seq, d, t, v

        sup = MonitorSupervisor(
            lambda: monitor(dev, names, shifts, strict_ids=False),
            os.path.join(SRC_DIR, "supervised"),
            checkpoint_every=SRC_CHECKPOINT_EVERY, device=dev)
        t0 = time.perf_counter()
        report = sup.run(crashing)
        torch.cuda.synchronize()
        sup_s = time.perf_counter() - t0
        check(report.n_crashes == 1 and report.n_restores == 1,
              f"10a supervisor: {report}")
        check(sup.monitor.counters == want_counters,
              "10a: the supervised monitor counts differently")
        arrays_equal(convert.monitor_arrays(sup.monitor), want,
                     "10a supervised", skip_moments=True)
        log(f"10a supervisor, checkpoint every {SRC_CHECKPOINT_EVERY} "
            f"slabs, crash at slab {SRC_CRASH_AT}: {report.n_slabs} slabs "
            f"folded, {report.n_skipped} skipped, {report.n_checkpoints} "
            f"checkpoints; {sup_s:.2f} s; bitwise the uninterrupted replay")
        del sup, want
        out["stream_ingest"].update(
            launches_10a=first["launches"],
            ms_10a={"inject": float(np.median(first["inj_ms"])),
                    "ingest": float(np.median(first["ing_ms"]))})
        del first
        torch.cuda.empty_cache()

        # 1,000 devices, the card against the CPU
        names_s, _, shifts_s, bank_s = fleet(dev, SRC_SMALL)
        small = []
        for d in (dev, cpu):
            m = monitor(d, names_s, shifts_s, strict_ids=False)
            rep = replay(bank_s, m, 0.0, SRC_STREAM_S, PERIOD_S, TICK_S,
                         faults=spec)
            small.append((rep, convert.monitor_arrays(m)))
        (rep_card, on_card), (rep_cpu, on_cpu) = small
        check(rep_card == rep_cpu,
              "10a: 1,000 devices count differently on the card and CPU")
        worst, scale = states_within_increment(
            on_card, on_cpu, "10a 1,000 devices card vs CPU")
        log(f"10a: {SRC_SMALL} devices faulted on the card and the CPU: "
            f"counters and injections equal ({rep_cpu}); energies within "
            f"{worst:.3e} x the stream's sum of |increment| ({scale:.6e} J)")
        del small, bank_s
    finally:
        replay_mod.FaultInjector = injector_cls
    torch.cuda.empty_cache()

    # -- 10b. stream_fleet over the fleet's profiles ---------------------------
    stream_ingest.launches = 0
    stream_ingest_grid.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = stream_fleet(n, profile=names, seed=SEED, compare=True,
                       device=dev)
    torch.cuda.synchronize()
    sf_s = time.perf_counter() - t0
    grid_10b = stream_ingest_grid.launches
    check(grid_10b > 0 and stream_ingest.launches == 0,
          f"10b: launches grid {grid_10b}, flat {stream_ingest.launches}")

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())
    r_naive = rel(res.naive_stream_j, res.naive_offline_j)
    r_corr = rel(res.corrected_stream_j, res.corrected_offline_j)
    check(r_naive <= 1e-11 and r_corr <= 1e-11,
          f"10b: stream vs offline {r_naive:.3e} / {r_corr:.3e}")
    moved = float((res.corrected_stream_j - res.naive_stream_j).abs().max())
    check(moved > 1e-3, f"10b: the corrections moved nothing ({moved})")
    audit = fleet_audit(n, names, seed=SEED, device=dev)
    r_audit = rel(res.naive_stream_j, audit.naive_j)
    check(r_audit <= 1e-11, f"10b: stream vs fleet_audit {r_audit:.3e}")
    log(f"10b stream_fleet: {n} devices ({res.n_samples} samples) in "
        f"{sf_s:.2f} s with the offline integrals "
        f"({res.n_samples / sf_s / 1e6:.1f} M samples/s), {grid_10b} "
        f"stream_ingest_grid launches; largest relative difference from "
        f"integrate_polled {r_naive:.3e} naive, {r_corr:.3e} corrected, "
        f"from fleet_audit's naive_j {r_audit:.3e}; the corrections move "
        f"a window by up to {moved:.4f} J")
    out["stream_ingest_grid"].update(launches_10b=grid_10b,
                                     s_10b=sf_s)
    del res, audit
    torch.cuda.empty_cache()

    # -- 10c. the collector at full width ---------------------------------------
    sampler = SimulatedSampler(bank, t0=0.0, period_s=PERIOD_S)
    store = ArtifactStore(os.path.join(SRC_DIR, "store"))
    gen = np.random.default_rng(SEED + 13)
    with_rec = np.sort(gen.choice(n, int(n * SRC_STORE_SHARE),
                                  replace=False))
    # what resolve_corrections must give: the record's correction where
    # one is active, identity ("uncalibrated") elsewhere
    want = {"gain": np.ones(n), "offset_w": np.zeros(n),
            "time_shift_s": np.zeros(n), "baseline_w": np.zeros(n),
            "ref_period_s": np.full(n, 0.1),
            "calibrated": np.zeros(n, dtype=bool)}
    labels = np.full(n, "uncalibrated", dtype=object)
    t0 = time.perf_counter()
    for i in with_rec:
        rec = dataclasses.replace(
            nominal_record(str(sampler.uuids[i]), profiles.get(names[i])),
            gain=float(1.0 + gen.uniform(-0.05, 0.05)),
            offset_w=float(gen.uniform(-5.0, 5.0)),
            fitted_at=SRC_NOW - 3600.0)
        store.save(rec, activate=True)
        for key, value in (("gain", rec.correction_gain),
                           ("offset_w", rec.correction_offset_w),
                           ("time_shift_s", rec.time_shift_s),
                           ("ref_period_s", rec.update_period_s),
                           ("calibrated", True)):
            want[key][i] = value
        labels[i] = rec.profile_name
    save_s = time.perf_counter() - t0
    corr = StreamCorrections(**{k: torch.as_tensor(v, device=dev)
                                for k, v in want.items()})
    pipe = CollectorPipeline(store=store, device=dev,
                             slab_samples=SRC_POLLS * n, now=SRC_NOW)
    reg_ms, feed_ms, sample_ms, resolve_ms = [], [], [], []
    timed_method(pipe.registry, "resolve", reg_ms)
    timed_method(pipe, "_resolve", resolve_ms)
    stream_ingest.launches = 0
    t_c = time.perf_counter()
    for _ in range(SRC_POLLS):
        t0 = time.perf_counter()
        batch = sampler.sample()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        pipe.feed(batch)
        feed_ms.append((time.perf_counter() - t0) * 1e3)
    mon_c = pipe.finish()
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t_c
    launches_10c = stream_ingest.launches
    check(launches_10c > 0, "10c: the collector ran no stream_ingest")
    check(pipe.assembler.n_slabs == 1 and mon_c.n_devices == n
          and pipe.n_active_records == with_rec.size,
          f"10c: {pipe.summary()}")
    for f in dataclasses.fields(corr):
        check(torch.equal(getattr(mon_c.corrections, f.name),
                          getattr(corr, f.name)),
              f"10c: the pipeline's resolved {f.name} differ from the "
              f"store's records")
    check(np.array_equal(mon_c.labels, labels), "10c: resolved labels")
    ref_c = MonitorService(n, corrections=corr, labels=labels,
                           strict_ids=False, device=dev)
    replay(bank, ref_c, 0.0, SRC_POLLS * PERIOD_S, PERIOD_S, TICK_S,
           chunk_devices=n, grid=False)
    check(mon_c.counters == ref_c.counters,
          f"10c: counters {mon_c.counters} vs replay {ref_c.counters}")
    arrays_equal(convert.monitor_arrays(mon_c), convert.monitor_arrays(ref_c),
                 "10c collector vs replay", skip_moments=True)
    assembler_ms = [f - r for f, r in zip(feed_ms[:-1], reg_ms[:-1])]
    log(f"10c collector: {SRC_POLLS} polls of {n} devices in "
        f"{collect_s:.2f} s, {launches_10c} stream_ingest launches; host ms "
        f"a poll: sampler {ms_stats(sample_ms)}, registry "
        f"{ms_stats(reg_ms)}, assembler besides the registry "
        f"{ms_stats(assembler_ms)}; the last poll (slab of "
        f"{SRC_POLLS * n} samples: the monitor built, its corrections "
        f"resolved, the slab ingested) {feed_ms[-1]:.1f} ms, of which "
        f"resolve_corrections over {n} uuids {resolve_ms[0]:.1f} ms; "
        f"{with_rec.size} store records saved in {save_s:.2f} s; the "
        f"corrections are the records', and the monitor bitwise a flat "
        f"replay of the same bank (the label moments aside)")
    out["stream_ingest"].update(
        launches_10c=launches_10c,
        ms_10c={"sampler": float(np.median(sample_ms)),
                "registry": float(np.median(reg_ms)),
                "assembler": float(np.median(assembler_ms)),
                "resolve": resolve_ms[0]})
    del mon_c, ref_c, pipe, sampler
    torch.cuda.empty_cache()

    # -- 10d. the card's own nvidia-smi log through the collector -------------
    uuid = subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    power = ("power.draw.instant" if "power.draw.instant" in smi_fields()
             else "power.draw")
    profile = "h100_instant" if power == "power.draw.instant" \
        else "h100_average"
    path = os.path.join(SRC_DIR, "nvidia_smi_10d.csv")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen_x = torch.Generator(device=dev)
    gen_x.manual_seed(SEED + 29)
    x = torch.randn((sms * FMA_BLOCK_ROWS, 128), generator=gen_x, device=dev)
    niter_ms = time_ms(lambda: fma_chain(x, FMA_NITERS[-1]), 5)
    niter_10ms = max(1, int(round(FMA_NITERS[-1] * SMI_HALF_S * 1e3
                                  / niter_ms)))
    fma_chain.launches = 0
    with open(path, "w") as f:
        proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu=uuid,timestamp,{power},"
             "utilization.gpu", "--format=csv", "-lms", "1"],
            stdout=f, stderr=subprocess.PIPE, text=True)
        try:
            time.sleep(0.3)
            t_end = time.time() + SRC_SMI_S
            while time.time() < t_end:
                fma_chain(x, niter_10ms)
                torch.cuda.synchronize()
                time.sleep(SMI_HALF_S)
            time.sleep(0.2)
            rc = proc.poll()
            err = proc.stderr.read() if rc is not None else ""
            check(rc is None, f"10d: nvidia-smi exited with {rc}: "
                  f"{err.strip()}")
        finally:
            if proc.poll() is None:
                proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stderr.close()
    fma_10d = fma_chain.launches
    check(fma_10d > 0, "10d: the load ran no fma_chain")
    args = ["replay", path, "--rebase", "--default-profile", profile]
    jsons = {k: os.path.join(SRC_DIR, f"replay_{k}.json")
             for k in ("card", "card_inproc", "cpu")}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.collect", *args, "--json",
         jsons["card"]], capture_output=True, text=True, env=env,
        timeout=600, cwd=ROOT)
    sub_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"10d: python -m repro_torch.collect "
          f"exited {proc.returncode}: {proc.stderr[-2000:]}")
    stream_ingest.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(args + ["--json", jsons["card_inproc"]]) == 0,
              "10d: the in-process replay on the card failed")
        launches_10d = stream_ingest.launches
        check(cli.main(args + ["--torch-device", "cpu", "--json",
                               jsons["cpu"]]) == 0,
              "10d: the replay on the CPU failed")
    check(launches_10d > 0, "10d: the replay ran no stream_ingest")
    got = {}
    for k, p in jsons.items():
        with open(p) as f:
            got[k] = json.load(f)
    card, cpu_j = got["card"], got["cpu"]
    check(got["card_inproc"] == card, "10d: the subprocess and the "
          "in-process replay on the card differ")
    for key in ("wire", "registry", "pipeline"):
        check(card[key] == cpu_j[key], f"10d: {key} differs card vs CPU: "
              f"{card[key]} vs {cpu_j[key]}")
    fe_card, fe_cpu = card["fleet_energy"], cpu_j["fleet_energy"]
    for key in ("corrected_j", "raw_j"):
        check(abs(fe_card[key] - fe_cpu[key]) <= 1e-12 * abs(fe_cpu[key]),
              f"10d: {key} card {fe_card[key]!r} vs CPU {fe_cpu[key]!r}")
    w = card["wire"]
    check(w["rows"] == w["samples"] + w["headers"] + w["malformed"]
          + w["not_available"] + w["error_cells"],
          f"10d: the wire counters miss rows: {w}")
    check(w["samples"] >= 100, f"10d: {w['samples']} readings")
    check(card["registry"]["uuids"] == [uuid],
          f"10d: registry {card['registry']['uuids']}, card {uuid}")
    batch, _ = wire.parse_log(path)
    t, p = batch.t, batch.power_w
    span = float(t.max() - t.min())
    same = p[1:] == p[:-1]
    change = np.flatnonzero(~same) + 1
    run_s = np.diff(t[change]) if change.size > 1 else np.empty(0)
    ing = card["pipeline"]["ingest"]
    log(f"10d the card's own nvidia-smi ({power}, -lms 1, {SRC_SMI_S} s "
        f"under fma_chain niter {niter_10ms} ~ 10 ms on, 10 ms off): "
        f"{w['samples']} readings of {w['rows']} rows (wire {w}), span "
        f"{span:.3f} s, median interval "
        f"{float(np.median(np.diff(t))) * 1e3:.3f} ms; "
        f"{float(same.mean()):.1%} of readings repeat the one before, "
        f"{np.unique(p).size} distinct values, median time between "
        f"changes {float(np.median(run_s)) * 1e3 if run_s.size else math.nan:.1f}"
        f" ms; ingest {ing}; raw {fe_card['raw_j']:.3f} J, corrected "
        f"{fe_card['corrected_j']:.3f} J ({profile}), mean "
        f"{fe_card['raw_j'] / span:.2f} W; python -m repro_torch.collect "
        f"on the card {sub_s:.1f} s; card equals the CPU, "
        f"{launches_10d} stream_ingest launches, {fma_10d} fma_chain")
    out["stream_ingest"].update(launches_10d=launches_10d)
    out["fma_chain"].update(launches_10d=fma_10d)
    out["stream_ingest"]["nvidia_smi_10d"] = dict(
        power=power, readings=w["samples"], span_s=span,
        repeat_share=float(same.mean()), distinct=int(np.unique(p).size),
        raw_j=fe_card["raw_j"], corrected_j=fe_card["corrected_j"],
        duplicates=ing["duplicates"], late=ing["late"])
    log(f"10: phase 10 took {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(os.path.join(SRC_DIR, "supervised"), ignore_errors=True)
    shutil.rmtree(os.path.join(SRC_DIR, "store"), ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the fleet audit
# ---------------------------------------------------------------------------
def log_filter_cases(dev):
    """Small adversarial log_filter inputs on ``dev``: per-device rows of
    very different lengths (zero-width padding), one shared row for many
    tick rows, ticks unsorted, on edges, before the first and after the
    last edge."""
    from repro_torch.core import load as loads
    from repro_torch.core.ground_truth import TimelineBank
    rng = np.random.default_rng(SEED + 11)
    tls = [loads.square_wave(0.23, 16, 220.0, 90.0),
           loads.multi_phase_workload([(0.13, 215.0), (0.07, 165.0)]),
           loads.square_wave(0.05, 2, 250.0, 60.0).shift(1.5),
           loads.square_wave(0.013, 400, 240.0, 70.0)]
    cases = []
    for rows in ([0, 1, 2], [3], [0], [1, 3, 2, 0]):
        bank = TimelineBank.from_timelines([tls[i] for i in rows],
                                           device=dev)
        g = len(rows) if len(rows) > 1 else 257
        ticks = rng.uniform(-2.0, 8.0, (g, 67))
        ticks[:, 0] = -40.0
        ticks[:, 1] = 60.0
        k = min(3, bank.edges.shape[1])
        ticks[:, 2:2 + k] = bank.edges[:, :k].cpu().numpy()
        tau = rng.uniform(0.01, 1.5, g)
        cases.append((bank.arrays, torch.as_tensor(ticks, device=dev),
                      torch.as_tensor(tau, device=dev)))
    return cases + [log_filter_long_case(dev, *shape, seed=SEED + i)
                    for i, shape in enumerate(log_filter_route_shapes())]


def log_filter_route_shapes():
    """(R, G, S, M) at the kernel's tile and route edges: G not a multiple
    of the tile's rows, G = 1, per-device rows with zero-width padding, S
    one below and at the size where a tile drops to one row, the largest S
    on the shared-memory route and one past it (two launches), per-device
    rows at the drop and past the largest."""
    from repro_torch.kernels import log_filter as k_log

    def edges(r):
        drop = next(s for s in range(1, 20000)
                    if k_log.plan(r, 64, s, 64)[1] == 1)
        last = max(s for s in range(drop, 20000)
                   if k_log.plan(r, 64, s, 64)[0] == k_log.SHARED_MEMORY)
        return drop, last
    drop, last = edges(1)
    drop_g, last_g = edges(3)
    return [(1, 1003, 64, 131), (1, 1, 64, 7440), (300, 300, 64, 97),
            (1, 40, drop - 1, 50), (1, 40, drop, 50), (1, 20, last, 60),
            (1, 20, last + 1, 60), (3, 3, drop_g, 40), (3, 3, last_g + 1, 40)]


def log_filter_long_case(dev, r, g, s, m, seed):
    """``r`` timeline rows of up to ``s`` segments (row 0 full, the others
    of random lengths, padded by repeating their last edge) and [g, m]
    ticks on ``dev``: far before the first edge, far past the last, on
    every edge of row 0, random in between."""
    from repro_torch.engine_backend.pytrees import TimelineArrays
    rng = np.random.default_rng(seed)
    edges = np.empty((r, s + 1))
    powers = np.empty((r, s))
    n_segs = np.full(r, s)
    for i in range(r):
        k = s if i == 0 else int(rng.integers(1, s + 1))
        edges[i, :k + 1] = 0.1 + np.concatenate(
            [[0.0], np.cumsum(rng.uniform(1e-3, 5e-3, k))])
        edges[i, k + 1:] = edges[i, k]
        powers[i, :k] = rng.uniform(60.0, 300.0, k)
        powers[i, k:] = 55.0
        n_segs[i] = k
    ticks = rng.uniform(-1.0, edges.max() + 1.0, (g, m))
    ticks[:, 0] = -1e6
    ticks[:, 1] = 1e6
    ticks[:, 2] = edges[0, 0]
    ticks[:, 3] = edges[0, -1]
    on_edges = edges[0][:m - 4]
    ticks[0, 4:4 + len(on_edges)] = on_edges
    tl = TimelineArrays(*to_card([edges, powers, np.full(r, 55.0), n_segs],
                                 dev))
    return (tl, torch.as_tensor(ticks, device=dev),
            torch.as_tensor(rng.uniform(0.01, 1.5, g), device=dev))


def sass_f64_count(name, function):
    """f64 instructions (``F64_OPCODE``, and conversions from or to f64)
    of ``function`` in kernel ``name``'s built library, by ``cuobjdump
    -sass``, on its path to the first unpredicated EXIT: the slow paths
    the compiler places after it (the division's) are not counted."""
    import re
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    body = re.split(r"Function : ", sass)
    text = next((b for b in body if b.startswith(function)), None)
    check(text is not None, f"{name}: no {function} in the SASS")
    count = 0
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", text):
        ins = m.group(1).strip()
        if ins == "EXIT" or ins.startswith("EXIT "):
            break
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
        if (op.startswith(F64_OPCODE) or (op[:3] in ("F2F", "I2F", "F2I")
                                          and ".F64" in op)):
            count += 1
    check(count > 0, f"{name}: no f64 instruction in {function}")
    return count


def log_filter_err(tl, ticks, tau):
    """The kernel against its plain version on the same card inputs:
    1e-12 relative plus 1e-9 W (CUDA's exp and glibc's may differ by an
    ulp); returns the largest absolute difference."""
    from repro_torch.engine_backend import torch_backend as tb
    from repro_torch.kernels.log_filter import log_filter
    got = log_filter(tl, ticks, tau)
    want = tb.log_filter(tl, ticks, tau)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "log_filter: non-finite reading")
    check(bool((diff <= 1e-12 * want.abs() + 1e-9).all()),
          f"log_filter off by {float(diff.max()):.3e} at "
          f"{tuple(ticks.shape)}")
    return float(diff.max())


def audit_fleet():
    """The audit's 100,000 profile names, kinds interleaved by a seeded
    permutation so every slab holds every kind."""
    names = (list(AUDIT_KINDS) * ((AUDIT_DEVICES - AUDIT_MODULE)
                                  // len(AUDIT_KINDS))
             + ["gh200_module_instant"] * AUDIT_MODULE)
    order = np.random.default_rng(SEED).permutation(len(names))
    return [names[i] for i in order]


def audit(dev):
    """Phase 5; returns the log_filter kernel's record."""
    from repro_torch.core import fleet_engine as fe
    from repro_torch.engine_backend import torch_backend as tb
    from repro_torch.kernels import _build
    from repro_torch.kernels import log_filter as k_log
    from repro_torch.kernels.log_filter import log_filter

    # -- 5a. small adversarial shapes, and each route's edges -----------------
    small_err = 0.0
    cases = log_filter_cases(dev)
    for tl, ticks, tau in cases:
        (r, s1), (g, m) = tl.edges.shape, ticks.shape
        route, rows = k_log.plan(r, g, s1 - 1, m)
        before = dict(log_filter.launches_by_route)
        err = log_filter_err(tl, ticks, tau)
        before[route] += 1
        check(log_filter.launches_by_route == before,
              f"log_filter at {[r, g, s1 - 1, m]} took another route than "
              f"{route}")
        small_err = max(small_err, err)
        log(f"  log_filter R={r} G={g} S={s1 - 1} M={m}: {route}, rows "
            f"{rows}, max_abs_err={err:.3e}")
    log(f"log_filter vs plain, {len(cases)} adversarial cases: max_abs_err="
        f"{small_err:.3e}")

    # -- 5b. a small audit on the card against the CPU plain path --------------
    names96 = (list(AUDIT_KINDS) + ["gh200_module_instant", "rtx3090_530"]) * 12
    small = [fe.fleet_audit(len(names96), names96, seed=SEED + 2,
                            good_practice=True, n_trials=AUDIT_TRIALS,
                            chunk_devices=40, device=d)
             for d in (dev, torch.device("cpu"))]
    worst = 0.0
    for key in ("naive_j", "gp_j"):
        a = getattr(small[0], key).cpu()
        b = getattr(small[1], key)
        check(bool((a - b).abs().le(1e-12 * b.abs() + 1e-9).all()),
              f"96-device audit: {key} differs card vs CPU")
        worst = max(worst, float(((a - b).abs() / b.abs()).max()))
    log(f"96-device audit: card matches the CPU plain path (largest "
        f"relative difference {worst:.3e})")

    # -- 5c. the main path: fleet_audit over 100,000 devices ------------------
    names = audit_fleet()
    captured = {}

    tiles = {}

    def recording(tl, ticks, tau):
        if ticks.numel() > captured.get("size", 0):
            captured.update(size=ticks.numel(), args=(tl, ticks, tau))
        plan = k_log.plan(tl.edges.shape[0], ticks.shape[0],
                          tl.edges.shape[1] - 1, ticks.shape[1])
        tiles[plan] = tiles.get(plan, 0) + 1
        return log_filter(tl, ticks, tau)

    fe.log_filter = recording
    try:
        k_log.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fe.fleet_audit(AUDIT_DEVICES, names, seed=SEED,
                             good_practice=True, n_trials=AUDIT_TRIALS,
                             chunk_devices=AUDIT_CHUNK, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = log_filter.launches
        by_route = dict(log_filter.launches_by_route)
    finally:
        fe.log_filter = log_filter
    check(launches > 0, "the audit ran no log_filter kernel")
    check(by_route[k_log.SHARED_MEMORY] == launches,
          f"the audit's log_filter launches by route: {by_route}")
    log(f"fleet_audit: {AUDIT_DEVICES} devices, naive + §5 "
        f"({AUDIT_TRIALS} trials), {AUDIT_CHUNK}-device slabs, in "
        f"{secs:.6f} s ({AUDIT_DEVICES / secs:.1f} devices/s), "
        f"{launches} log_filter launches; by route {by_route}; (route, "
        f"rows a tile): launches {tiles}")

    # -- 5d. what came out ------------------------------------------------------
    for e in (res.naive_j, res.gp_j, res.naive_err, res.gp_err):
        check(e.shape == (AUDIT_DEVICES,) and bool(torch.isfinite(e).all()),
              "audit result malformed")
    arr = np.asarray(names)
    for prof in AUDIT_KINDS + ("gh200_module_instant",):
        sel = torch.as_tensor(arr == prof, device=dev)
        log(f"  {prof:22s} n={int(sel.sum()):6d} mean |err| naive "
            f"{float(res.naive_err[sel].abs().mean()):.4%}, good practice "
            f"{float(res.gp_err[sel].abs().mean()):.4%}")
    for key, errs in (("naive", res.naive_err), ("good_practice",
                                                 res.gp_err)):
        exact = res.stats(errs)
        streamed = res.streamed[key]["overall"]
        check(streamed["n_devices"] == AUDIT_DEVICES, f"{key}: moment count")
        for k in ("mean_err", "mean_abs_err", "std_err", "worst_abs"):
            check(abs(streamed[k] - exact[k]) <= 1e-9,
                  f"{key}: streamed {k} {streamed[k]} vs exact {exact[k]}")
        log(f"  {key}: mean err {exact['mean_err']:+.4%}, mean |err| "
            f"{exact['mean_abs_err']:.4%}, p99 |err| {exact['p99_abs']:.4%}"
            f"; streamed moments match the exact ones within 1e-9")

    # -- 5e. the kernel at the audit's largest log_filter shape ---------------
    tl, ticks, tau = captured["args"]
    err = log_filter_err(tl, ticks, tau)
    ms = time_ms(lambda: log_filter(tl, ticks, tau), 20)
    plain_ms = time_ms(lambda: tb.log_filter(tl, ticks, tau), 3)
    g, m = ticks.shape
    r, s1 = tl.edges.shape
    s = s1 - 1
    plan = k_log.plan(r, g, s, m)
    # bytes: ticks in, readings out, tau, the timeline rows
    nbytes = 8 * (2 * g * m + g + r * (2 * s + 2))
    # f64 instructions of the built kernel (cuobjdump -sass of its probes
    # log_filter_tick_ops / log_filter_step_ops, the same inline functions
    # the kernel runs): per tick a reading and one compare per step of the
    # search over the S + 1 edges; per (row, segment) a decay and a step
    tick_ops = sass_f64_count("log_filter", "log_filter_tick_ops")
    step_ops = sass_f64_count("log_filter", "log_filter_step_ops")
    search = s1.bit_length()
    ops = g * m * (tick_ops + search) + g * s * step_ops
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP64_INSTR_PER_S * 1e3
    log(f"log_filter at [{g}, {m}] ({r} timeline row(s), {s} segments; "
        f"{plan[0]}, rows {plan[1]}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
        f"{bytes_ms:.4f}: {nbytes}; f64 issue {ops_ms:.4f}: {tick_ops} + "
        f"{search} instructions a tick, {step_ops} a segment by the SASS), "
        f"max_abs_err {err:.3e}")
    return dict(
        name="log_filter", route="cuda",
        source=f"src/repro_torch/kernels/csrc/{_build.SOURCES['log_filter']}",
        replaces=REPLACES["log_filter"], launches=launches,
        max_abs_err=max(err, small_err), ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, shape=[g, m, r, s], bytes=nbytes,
        f64_instructions=ops, f64_per_tick=tick_ops + search,
        f64_per_segment=step_ops, launches_by_route=by_route,
        tile_rows=plan[1], audit_s=secs,
        audit_devices_per_s=AUDIT_DEVICES / secs)


# ---------------------------------------------------------------------------
# the scalar §5 path
# ---------------------------------------------------------------------------
def step_cases(dev):
    """Small adversarial step_integrate inputs on ``dev``: rows of padding
    only and of one sample, windows before the first sample, after the
    last, across padding and of zero length, t0 > t1, repeated timestamps,
    window edges on samples; then M = 1 and M = 0."""
    inf = math.inf
    base = [0.1, 0.2, 0.3, 0.45, 0.5, 0.8, 1.0, 1.3, 1.4]

    def pad(xs):
        return xs + [inf] * (9 - len(xs))
    rows = [(base, 0.25, 1.1), (base, -1.0, 5.0), (pad([]), 0.0, 1.0),
            (pad([0.7]), 0.5, 0.9), (base, -2.0, 0.05),
            (pad(base[:5]), 0.6, 0.9), (pad(base[:5]), 0.15, 3.0),
            (base, 0.9, 0.4), (pad([0.1, 0.2, 0.2, 0.2, 0.3, 0.3, 0.6]),
                               0.2, 0.3),
            (base, 0.3, 1.0), (base, 0.5, 0.5), (pad(base[:2]), 0.2, 0.2)]
    ts = np.array([r[0] for r in rows])
    rng = np.random.default_rng(SEED + 13)
    cases = [(ts, rng.uniform(60.0, 250.0, ts.shape),
              np.array([r[1] for r in rows]), np.array([r[2] for r in rows])),
             (np.array([[0.5], [inf], [0.5], [0.5]]),
              np.array([[100.0], [7.0], [100.0], [100.0]]),
              np.array([0.0, 0.0, 0.6, 0.5]), np.array([1.0, 1.0, 0.9, 0.5])),
             (np.zeros((3, 0)), np.zeros((3, 0)), np.zeros(3), np.ones(3))]
    # one row at a §5 trial's M = 7440: windows from before the first
    # sample (j0 = 0), to past the last (j1 = M - 1), between two samples
    # (empty) and t0 > t1; then times repeated across the kernel's pivots
    # (every 30th sample at 256 threads), windows starting and ending on
    # them
    m = 7440
    trial = np.cumsum(rng.uniform(0.5e-3, 1.5e-3, m))
    vals = rng.uniform(60.0, 250.0, m)
    cases.append((np.tile(trial, (4, 1)), np.tile(vals, (4, 1)),
                  np.array([trial[0] - 1.0, trial[100], trial[3000] + 1e-5,
                            trial[5000]]),
                  np.array([trial[4000], trial[-1] + 1.0,
                            trial[3000] + 2e-5, trial[4000]])))
    rep = trial.copy()
    for p in (30, 60, 3000, 7410):
        rep[p - 2:p + 3] = rep[p]
    rep = np.maximum.accumulate(rep)
    cases.append((np.tile(rep, (5, 1)), np.tile(vals, (5, 1)),
                  rep[[30, 60, 3000, 30, 7410]],
                  np.append(rep[[30, 3000, 7410, 60]], rep[7410] + 1e-6)))
    cases = [to_card(c, dev) for c in cases]
    # M just below, at and above a multiple of the kernel's block (256
    # threads up to M = 8192, then 512, then 1024)
    for m in (255, 256, 257, 8191, 8192, 8193, 16383, 16384, 16385):
        cases.append(step_wide_case(dev, 6, m))
    return cases


def step_wide_case(dev, n, m):
    """[n, m] rows on ``dev``: sorted times at up to 2 ms gaps, a tenth of
    them repeated, inf-padded from a random length on, with windows that
    start before the first sample and end anywhere, padding included."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    f64 = dict(dtype=torch.float64, device=dev, generator=gen)
    gaps = torch.rand((n, m), **f64) * 2e-3
    ts = torch.cumsum(torch.where(gaps < 2e-4, 0.0, gaps), 1)
    k = torch.randint(m // 2, m + 1, (n,), generator=gen, device=dev)
    ts = torch.where(torch.arange(m, device=dev)[None, :] >= k[:, None],
                     math.inf, ts)
    t0 = torch.rand(n, **f64) * 2.0 - 0.2
    return [ts, 60.0 + 190.0 * torch.rand((n, m), **f64), t0,
            t0 + torch.rand(n, **f64) * 8.0]


def step_tolerance(ts, vals, t0, t1, trapezoid):
    """Per row, 1e-12 × Σ|dens·dt| over the row plus 1e-12 × |tail|: the
    kernel sums the window in a tree order, the plain version differences
    a prefix sum."""
    n, m = ts.shape
    if m == 0:
        return torch.zeros(n, dtype=torch.float64, device=ts.device)
    fin = torch.isfinite(ts[:, 1:])
    dt = torch.where(fin, ts[:, 1:], 0.0) - torch.where(fin, ts[:, :-1], 0.0)
    dens = (0.5 * (vals[:, :-1] + torch.where(fin, vals[:, 1:], 0.0))
            if trapezoid else vals[:, :-1])
    j0 = (ts < t0[:, None]).sum(1)
    j1 = (ts <= t1[:, None]).sum(1) - 1
    j1c = torch.clamp(j1, 0, m - 1)[:, None]
    tail = (torch.gather(vals, 1, j1c) * (t1[:, None]
                                           - torch.gather(ts, 1, j1c)))[:, 0]
    tail = torch.where((j1 >= j0) & (j0 < m), tail.abs(), 0.0)
    return 1e-12 * ((dens * dt).abs().sum(1) + tail)


def step_err(args, trapezoid):
    """The kernel against its plain version on the same card inputs;
    returns the largest absolute difference."""
    from repro_torch.engine_backend import torch_backend as tb
    from repro_torch.kernels.step_integrate import step_integrate
    got = step_integrate(*args, trapezoid=trapezoid)
    want = tb.step_integrate(*args, trapezoid=trapezoid)
    torch.cuda.synchronize()
    shape = tuple(args[0].shape)
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"step_integrate at {shape}: output malformed")
    diff = (got - want).abs()
    check(bool((diff <= step_tolerance(*args, trapezoid)).all()),
          f"step_integrate off by {float(diff.max()):.3e} at {shape} "
          f"(trapezoid={trapezoid})")
    return float(diff.max()) if diff.numel() else 0.0


def energy_grid(dev):
    """``benchmarks/energy_cases.py``'s Figs. 15-17 grid through the
    port's scalar protocols on ``dev``: {(case, load, seed): (naive J, §5
    J per repetition, truth J)}."""
    from repro_torch.core import load as loads
    from repro_torch.core import meter as pm
    from repro_torch.core import profiles
    from repro_torch.core.calibrate import CalibrationRecord
    from repro_torch.core.sensor import OnboardSensor
    out = {}
    for case, prof_name, W, rise in ENERGY_CASES:
        prof = profiles.get(prof_name)
        calib = CalibrationRecord(
            "bench", prof_name, prof.update_period_s, W,
            "instant" if W <= prof.update_period_s else "linear", rise,
            sampled_fraction=min(1.0, W / prof.update_period_s))
        for load_name, dur in ENERGY_LOADS:
            wl = pm.Workload(load_name, loads.multi_phase_workload(
                [(dur * 0.5, 235.0), (dur * 0.5, 150.0)]))
            for seed in range(ENERGY_SEEDS):
                naive = pm.measure_naive(
                    OnboardSensor(prof, seed=900 + seed, device=dev), wl,
                    start_offset_s=0.3 + seed * 0.041)
                est = pm.measure_good_practice(
                    OnboardSensor(prof, seed=900 + seed, device=dev), wl,
                    calib, pm.GoodPracticeConfig(n_trials=2), seed=seed)
                out[(case, load_name, seed)] = (naive, est.joules_per_rep,
                                                wl.true_energy_j)
    return out


def batch_vs_scalar(dev):
    """Phase 6c's protocols on ``dev``: for 8 devices of the audit's kinds
    (Kepler and Maxwell among them, so the scalar sensors run
    ``log_filter``), the batched naive and §5 energies and the scalar ones
    on ``bank.scalar_reference(i)`` with the same protocol seed."""
    from repro_torch.core import load as loads
    from repro_torch.core import meter as pm
    from repro_torch.core import profiles
    from repro_torch.core.calibrate import nominal_record
    from repro_torch.core.fleet_engine import SensorBank
    names = list(AUDIT_KINDS) + ["gh200_module_instant", "rtx3090_530"]
    bank = SensorBank.from_catalog(names, seed=SEED + 5, device=dev)
    wl = pm.Workload("audit_burst", loads.multi_phase_workload(
        [(0.130, 215.0), (0.070, 165.0)]))
    calibs = {n: nominal_record("fleet", profiles.get(n)) for n in names}
    cfg = pm.GoodPracticeConfig(n_trials=AUDIT_TRIALS)
    naive_b = pm.measure_naive_batch(bank, wl, host_baseline_w=25.0)
    gp_b = pm.measure_good_practice_batch(bank, wl, calibs, cfg,
                                          host_baseline_w=25.0)
    out = dict(naive_batch=[float(x) for x in naive_b],
               gp_batch=[float(x) for x in gp_b.joules_per_rep],
               naive_scalar=[], gp_scalar=[])
    for i, name in enumerate(names):
        base = 25.0 if bool(bank.module_scope[i]) else None
        out["naive_scalar"].append(pm.measure_naive(
            bank.scalar_reference(i), wl, host_baseline_w=base))
        out["gp_scalar"].append(pm.measure_good_practice(
            bank.scalar_reference(i), wl, calibs[name], cfg,
            host_baseline_w=base, seed=i).joules_per_rep)
    return out


def scalar_path(dev):
    """Phase 6; returns the step_integrate kernel's record and what phase
    6c adds to the log_filter kernel's."""
    from repro_torch.core import fleet_engine as fe
    from repro_torch.core import load as loads
    from repro_torch.core import meter as pm
    from repro_torch.core import profiles
    from repro_torch.core.calibrate import CalibrationRecord
    from repro_torch.core.sensor import OnboardSensor
    from repro_torch.engine_backend import torch_backend as tb
    from repro_torch.kernels import _build
    from repro_torch.kernels import log_filter as k_log
    from repro_torch.kernels import step_integrate as k_step
    from repro_torch.kernels.log_filter import log_filter
    from repro_torch.kernels.step_integrate import step_integrate

    # -- 6a. the kernel against its plain version -----------------------------
    cases = step_cases(dev)
    small_err = max(step_err(c, trap) for c in cases
                    for trap in (False, True))
    log(f"step_integrate vs plain, {len(cases)} adversarial cases (M "
        f"{sorted({int(c[0].shape[1]) for c in cases})}) x 2 rules: "
        f"max_abs_err={small_err:.3e}")
    calib_a100 = CalibrationRecord("d0", "a100", 0.100, 0.025, "instant",
                                   0.25, sampled_fraction=0.25)
    burst = pm.Workload("burst100ms", loads.workload_burst(0.100, 210.0))
    captured = {}

    def recording(*args, **kw):
        captured.setdefault("trial", args)
        return step_integrate(*args, **kw)

    pm.step_integrate = recording
    try:
        pm.measure_good_practice(
            OnboardSensor(profiles.get("a100"), seed=900, device=dev), burst,
            calib_a100, pm.GoodPracticeConfig(n_trials=2), seed=0)
    finally:
        pm.step_integrate = step_integrate
    trial = list(captured["trial"])
    wide = step_wide_case(dev, *STEP_WIDE)
    err = max(step_err(a, trap) for a in (trial, wide)
              for trap in (False, True))
    log(f"step_integrate vs plain at a §5 trial's {list(trial[0].shape)} "
        f"and at {list(STEP_WIDE)}: max_abs_err={err:.3e}")

    # -- 6b. the main path: the Figs. 15-17 grid on the card and the CPU ------
    step_integrate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = energy_grid(dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = step_integrate.launches
    check(launches > 0, "the scalar protocols ran no step_integrate kernel")
    cpu = energy_grid(torch.device("cpu"))
    worst = 0.0
    for key, (naive, gp, _) in card.items():
        for got, want in ((naive, cpu[key][0]), (gp, cpu[key][1])):
            rel = abs(got - want) / abs(want)
            worst = max(worst, rel)
            check(rel <= 1e-12, f"energy grid {key}: card {got!r} vs CPU "
                  f"{want!r}")
    log(f"energy grid: {len(card)} runs (naive + §5, 2 trials) on the card "
        f"in {secs:.3f} s, {launches} step_integrate launches; card matches "
        f"the CPU plain path (largest relative difference {worst:.3e})")
    for case, _, _, _ in ENERGY_CASES:
        for load_name, _ in ENERGY_LOADS:
            runs = [card[(case, load_name, s)] for s in range(ENERGY_SEEDS)]
            ne = [abs(n - t) / t for n, _, t in runs]
            ge = [abs(g - t) / t for _, g, t in runs]
            log(f"  {case}/{load_name}: mean |err| naive {np.mean(ne):.2%}, "
                f"good practice {np.mean(ge):.2%}")

    # -- 6c. batched protocols against scalar_reference(i), card and CPU -----
    lf_args = []

    def recording_lf(tl, ticks, tau):
        lf_args.append((tl, ticks, tau))
        return log_filter(tl, ticks, tau)

    fe.log_filter = recording_lf
    try:
        step_integrate.launches = 0
        k_log.reset_launches()
        card = batch_vs_scalar(dev)
        torch.cuda.synchronize()
        step_6c, lf_6c = step_integrate.launches, log_filter.launches
    finally:
        fe.log_filter = log_filter
    check(lf_6c > 0, "batched vs scalar ran no log_filter kernel")
    check(step_6c > 0, "batched vs scalar ran no step_integrate kernel")
    cpu = batch_vs_scalar(torch.device("cpu"))
    worst = 0.0
    for key in card:
        for got, want in zip(card[key], cpu[key]):
            rel = abs(got - want) / abs(want)
            worst = max(worst, rel)
            check(rel <= 1e-12, f"batched vs scalar, {key}: card {got!r} vs "
                  f"CPU {want!r}")
    d_naive = d_gp = 0.0
    for i in range(len(card["naive_batch"])):
        d_naive = max(d_naive, abs(card["naive_batch"][i]
                                   - card["naive_scalar"][i]))
        d_gp = max(d_gp, abs(card["gp_batch"][i] - card["gp_scalar"][i]))
    check(d_naive <= 1e-9, f"batched naive off scalar_reference by {d_naive}")
    check(d_gp <= 1e-3, f"batched §5 off scalar_reference by {d_gp}")
    lf_err = max(log_filter_err(*a) for a in lf_args)
    lf_shapes = sorted({tuple(a[1].shape) for a in lf_args})
    log(f"{len(card['naive_batch'])} devices, batched vs scalar_reference(i) "
        f"on the card: naive within {d_naive:.3e} J, §5 within {d_gp:.3e} J; "
        f"card matches the CPU plain path (largest relative difference "
        f"{worst:.3e}); {lf_6c} log_filter and {step_6c} step_integrate "
        f"launches; log_filter vs plain at that path's tick shapes "
        f"{[list(x) for x in lf_shapes]}: max_abs_err={lf_err:.3e}")

    # -- 6d. compare_protocols on the a100 burst ------------------------------
    naive_e, gp_e = [], []
    for seed in range(5):
        r = pm.compare_protocols(
            OnboardSensor(profiles.get("a100"), seed=300 + seed, device=dev),
            burst, calib_a100, pm.GoodPracticeConfig(), seed=seed)
        naive_e.append(r["naive_err"])
        gp_e.append(r["gp_err"])
    log("compare_protocols, a100, 100 ms burst, seeds 0-4: naive err "
        + " ".join(f"{e:+.2%}" for e in naive_e) + "; good practice "
        + " ".join(f"{e:+.2%}" for e in gp_e))
    check(np.mean(np.abs(gp_e)) < np.mean(np.abs(naive_e)),
          "good practice did not beat naive on the a100 burst")

    # -- 6e. times at the trial's shape and the wide shape --------------------
    def bound(args):
        """(bound ms, what bounds it, bytes needed, bytes of whole rows):
        what these windows need is 16 bytes per selected sample (its time
        and reading) and 24 per row (t0, t1, the integral); reading every
        input whole would be N·M·16 + N·24."""
        ts, _, a, b = args
        n, m = ts.shape
        j0 = (ts < a[:, None]).sum(1)
        j1 = (ts <= b[:, None]).sum(1) - 1
        sel = int(torch.where((j1 >= j0) & (j0 < m), j1 - j0 + 1, 0).sum())
        need = sel * 16 + n * 24
        bytes_ms = need / HBM_BYTES_PER_S * 1e3
        ops_ms = sel * STEP_OPS_PER_SAMPLE / FP64_OPS_PER_S * 1e3
        return (max(bytes_ms, ops_ms),
                "bytes" if bytes_ms >= ops_ms else "operations",
                need, n * m * 16 + n * 24)

    ms = time_ms(lambda: step_integrate(*trial), 200)
    floor_ms = time_ms(lambda: k_step.empty_launch(trial[0]), 200)
    plain_ms = time_ms(lambda: tb.step_integrate(*trial), 50)
    ms_wide = time_ms(lambda: step_integrate(*wide), 20)
    floor_wide = time_ms(lambda: k_step.empty_launch(wide[0]), 20)
    plain_wide = time_ms(lambda: tb.step_integrate(*wide), 5)
    (b_ms, by, need, full), (b_wide, _, need_w, full_w) = (bound(trial),
                                                           bound(wide))
    log(f"step_integrate at {list(trial[0].shape)}: kernel {ms:.5f} ms, "
        f"an empty launch of its grid {floor_ms:.5f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.7f} ms ({need} of {full} bytes); "
        f"at {list(STEP_WIDE)}: kernel {ms_wide:.4f} ms, empty launch "
        f"{floor_wide:.5f} ms, plain {plain_wide:.3f} ms, bound "
        f"{b_wide:.4f} ms ({need_w} of {full_w} bytes)")
    return dict(
        name="step_integrate", route="cuda",
        source=f"src/repro_torch/kernels/csrc/"
               f"{_build.SOURCES['step_integrate']}",
        replaces=REPLACES["step_integrate"], launches=launches,
        max_abs_err=max(err, small_err), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=by, library_ms=None,
        shape=list(trial[0].shape), bytes=need, bytes_rows=full,
        launch_floor_ms=floor_ms, launch_floor_ms_wide=floor_wide,
        ms_wide=ms_wide, plain_ms_wide=plain_wide, bound_ms_wide=b_wide,
        bytes_wide=need_w, bytes_rows_wide=full_w,
        shape_wide=list(STEP_WIDE), grid_s=secs, launches_6c=step_6c), dict(
        launches_6c=lf_6c, max_abs_err_6c=lf_err,
        shapes_6c=[list(x) for x in lf_shapes])


# ---------------------------------------------------------------------------
# the paper's load and the black-box characterisation
# ---------------------------------------------------------------------------
def fma_cases(dev):
    """fma_chain inputs on ``dev``: the reference's four cases
    (tests/test_kernels.py), then inputs holding the values on which the
    chain is not the identity (in active and idle slots), at block_rows
    256, 128 and 512: (x, niter, fraction, block_rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)

    def x(rows):
        v = torch.randn((rows, 128), generator=gen, device=dev)
        for r in range(0, rows, 128):
            v[r, :len(FMA_ADVERSARIAL)] = torch.tensor(FMA_ADVERSARIAL)
        return v
    return ([(torch.randn((rows, 128), generator=gen, device=dev), niter,
              frac, 256) for rows, niter, frac in FMA_REFERENCE_CASES]
            + [(x(1024), 5, 0.5, 256), (x(512), 7, 0.5, 128),
               (x(1024), 5, 0.6, 512)])


def fma_err(x, niter, frac, block_rows):
    """The kernel against its plain version on the same card input,
    bitwise, a nan meeting a nan of any bits; returns the largest absolute
    difference of the finite outputs (0.0 when bitwise equal)."""
    from repro_torch.engine_backend import torch_backend as tb
    from repro_torch.kernels.fma_chain import fma_chain
    got = fma_chain(x, niter, frac, block_rows)
    want = tb.fma_chain(x, niter, frac, block_rows)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    same = torch.equal(torch.isnan(got), nan) and torch.equal(
        got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    check(same, f"fma_chain at {list(x.shape)}, niter {niter}, fraction "
          f"{frac}, block_rows {block_rows}: not bitwise equal to the plain "
          f"version (largest finite difference {err:.3e})")
    return err


def fma_chain_sass_loop():
    """The innermost loop of the built fma_chain kernel that issues FFMA,
    from ``cuobjdump -sass``: (instructions, FFMA count, the others)."""
    import re
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(_build.library_path("fma_chain"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    ins = [(int(m.group(1), 16), m.group(2).strip())
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    loops = []
    for addr, text in ins:
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            n_ffma = sum(t.startswith("FFMA") for t in body)
            if n_ffma:
                loops.append((len(body), n_ffma,
                              [t for t in body if not t.startswith("FFMA")]))
    check(bool(loops), "fma_chain: no loop of FFMA in the SASS")
    return min(loops)


def smi_fields():
    """The columns 7c polls: timestamp, power.draw and, where this
    nvidia-smi lists it, power.draw.instant."""
    helptext = subprocess.run(["nvidia-smi", "--help-query-gpu"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout
    return ["timestamp", "power.draw"] + (
        ["power.draw.instant"] if '"power.draw.instant"' in helptext else [])


def smi_reading(text):
    """A number of nvidia-smi's csv (nounits), nan for "[N/A]" and the
    like."""
    text = text.strip()
    return math.nan if text.startswith("[") else float(text)


def smi_parse(path, fields):
    """(epoch seconds [K], {field: watts [K]}) of the polled csv."""
    ts, cols = [], {f: [] for f in fields[1:]}
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != len(fields):
                continue
            ts.append(datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f")
                      .timestamp())
            for name, text in zip(fields[1:], parts[1:]):
                cols[name].append(smi_reading(text))
    return np.asarray(ts), {k: np.asarray(v) for k, v in cols.items()}


def smi_load(dev, x, niter_10ms):
    """7c: nvidia-smi polls the card every 1 ms while the host drives an
    8 s square wave of fma_chain (10 ms on, 10 ms asleep), then 2 s
    plateaus at each fraction of 7b (asleep at 0).  Returns what it
    read."""
    from repro_torch.core import microbench as mb
    from repro_torch.kernels.fma_chain import fma_chain
    fields = smi_fields()
    path = os.path.join(ROOT, "build", "nvidia_smi_power.csv")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as out:
        proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader,nounits", "-lms", "1"],
            stdout=out, stderr=subprocess.PIPE, text=True)
        try:
            time.sleep(1.0)
            wave = [time.time()]
            while time.time() - wave[0] < SMI_WAVE_S:
                fma_chain(x, niter_10ms)
                torch.cuda.synchronize()
                time.sleep(SMI_HALF_S)
            wave.append(time.time())
            marks = []
            for frac in FMA_FRACTIONS:
                t0 = time.time()
                while time.time() - t0 < SMI_PLATEAU_S:
                    if frac == 0.0:
                        time.sleep(SMI_HALF_S)
                    else:
                        fma_chain(x, niter_10ms, frac)
                        torch.cuda.synchronize()
                marks.append((frac, t0, time.time()))
            time.sleep(0.2)
            rc = proc.poll()
            err = proc.stderr.read() if rc is not None else ""
            check(rc is None, f"nvidia-smi exited with {rc} while polling: "
                  f"{err.strip()}")
        finally:
            if proc.poll() is None:
                proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stderr.close()
    ts, cols = smi_parse(path, fields)
    check(len(ts) >= 100, f"nvidia-smi gave {len(ts)} readings in "
          f"{SMI_WAVE_S + len(FMA_FRACTIONS) * SMI_PLATEAU_S:.0f} s")
    check(bool(np.isfinite(cols["power.draw"]).all()),
          "nvidia-smi power.draw is not a number")
    interval_ms = float(np.median(np.diff(ts))) * 1e3
    in_wave = (ts >= wave[0]) & (ts <= wave[1])
    out = dict(fields=fields, readings=int(len(ts)),
               poll_interval_ms=interval_ms, update_period_s={},
               complete_runs={}, plateaus_w={})
    for name, vals in cols.items():
        if not np.isfinite(vals).all():
            continue
        runs = mb.complete_run_durations(ts[in_wave], vals[in_wave]).numpy()
        out["complete_runs"][name] = int(runs.size)
        out["update_period_s"][name] = (float(np.median(runs))
                                        if runs.size >= 3 else math.nan)
        out["plateaus_w"][name] = [
            float(np.mean(vals[(ts >= t0 + 0.5 * (t1 - t0)) & (ts <= t1)]))
            for _, t0, t1 in marks]
    return out


def characterisation(dev):
    """7d's characterisations on ``dev``: {name: result} for a100 (with a
    GroundTruthMeter), v100 and rtx3090_average through ``characterise``,
    kepler through ``measure_transient``, and the update period of four
    sensor classes; plus each sensor's hidden gain."""
    from repro_torch.core import microbench as mb
    from repro_torch.core import profiles
    from repro_torch.core.ground_truth import GroundTruthMeter
    from repro_torch.core.sensor import OnboardSensor

    def sensor(name, seed):
        return OnboardSensor(profiles.get(name), seed=seed, device=dev)
    a100 = sensor("a100", 9)
    out = {"a100": mb.characterise(a100, GroundTruthMeter(seed=2, device=dev),
                                   boxcar_reps=6),
           "v100": mb.characterise(sensor("v100", 9), boxcar_reps=6),
           "rtx3090_average": mb.characterise(sensor("rtx3090_average", 3),
                                              boxcar_reps=6),
           "kepler": mb.measure_transient(sensor("kepler", 3), 0.015),
           "a100_true_gain": a100.true_gain}
    for name, _ in CHAR_PERIODS:
        out[f"period_{name}"] = mb.estimate_update_period(sensor(name, 7))
    return out


def char_numbers(res):
    """Every number of a 7d result, flattened in a fixed order, and the
    transient kinds."""
    nums, kinds = [], []
    for key in sorted(res):
        r = res[key]
        if isinstance(r, float):
            nums.append(r)
            continue
        tr = getattr(r, "transient", r)
        kinds.append(tr.kind)
        nums += [tr.rise_time_s, tr.delay_s, tr.settle_w]
        if tr is not r:
            nums += [r.update_period_s, r.sampled_fraction] + [
                math.nan if v is None else v
                for v in (r.window_s, r.gain, r.offset_w, r.r2)]
    return nums, kinds


def paper_load(dev):
    """Phase 7; returns the fma_chain kernel's record and what 7d adds to
    log_filter's and 7e to step_integrate's."""
    import tempfile
    from repro_torch.core import load as loads
    from repro_torch.core import meter as pm
    from repro_torch.core import microbench as mb
    from repro_torch.core import profiles
    from repro_torch.core.calibrate import CalibrationRecord, CalibrationStore
    from repro_torch.core.ground_truth import GroundTruthMeter
    from repro_torch.core.sensor import OnboardSensor
    from repro_torch.engine_backend import torch_backend as tb
    from repro_torch.kernels import _build
    from repro_torch.kernels import log_filter as k_log
    from repro_torch.kernels.fma_chain import fma_chain
    from repro_torch.kernels.log_filter import log_filter
    from repro_torch.kernels.step_integrate import step_integrate

    # -- 7a. the kernel against its plain version, bitwise ---------------------
    n_ins, n_ffma, others = fma_chain_sass_loop()
    log(f"fma_chain SASS: the niter loop is {n_ins} instructions, {n_ffma} "
        f"FFMA ({n_ffma / 64:g} iteration(s) of 2 FMAs on 32 chains) and "
        f"{others}")
    cases = fma_cases(dev)
    small_err = max(fma_err(*c) for c in cases)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    x = torch.randn((sms * FMA_BLOCK_ROWS, 128), generator=gen, device=dev)
    err = max(fma_err(x, FMA_NITERS[-1], f, FMA_BLOCK_ROWS)
              for f in (1.0, 0.2))
    log(f"fma_chain vs plain, {len(cases)} small cases (adversarial values, "
        f"block_rows 128/256/512) and [{sms * FMA_BLOCK_ROWS}, 128] at niter "
        f"{FMA_NITERS[-1]}, fractions 1.0 and 0.2: bitwise equal")

    # -- 7b. Fig. 5 on the card: time linear in niter, one slot per SM --------
    fma_chain.launches = 0
    by_niter = [time_ms(lambda n=n: fma_chain(x, n), 20) for n in FMA_NITERS]
    slope, intercept = np.polyfit(FMA_NITERS, by_niter, 1)
    pred = np.polyval([slope, intercept], FMA_NITERS)
    r2 = 1.0 - (np.sum((np.asarray(by_niter) - pred) ** 2)
                / np.sum((np.asarray(by_niter) - np.mean(by_niter)) ** 2))
    log("fma_chain, Fig. 5: " + " ".join(
        f"niter {n}: {t:.4f} ms" for n, t in zip(FMA_NITERS, by_niter))
        + f"; slope {slope * 1e3:.4f} us/iteration, intercept "
        f"{intercept:.4f} ms, R^2 {r2:.6f}")
    check(r2 > 0.97 and slope > 0, f"fma_chain time not linear in niter "
          f"(R^2 {r2:.4f}, slope {slope:.3e})")
    niter = FMA_NITERS[-1]
    by_frac = [time_ms(lambda f=f: fma_chain(x, niter, f), 10)
               for f in FMA_FRACTIONS]
    log(f"fma_chain at niter {niter} by fraction: " + " ".join(
        f"{f}: {t:.4f} ms" for f, t in zip(FMA_FRACTIONS, by_frac)))
    t_full, t_fifth = by_frac[FMA_FRACTIONS.index(1.0)], by_frac[
        FMA_FRACTIONS.index(0.2)]
    check(t_full <= 1.5 * t_fifth, f"fma_chain at fraction 1.0 takes "
          f"{t_full:.4f} ms, over 1.5x its {t_fifth:.4f} ms at 0.2: slots "
          f"are not one per SM")
    ms = by_niter[-1]
    launches_7b = fma_chain.launches
    plain_ms = time_ms(lambda: tb.fma_chain(x, niter), 1)
    n_rows = x.shape[0]
    flops = 4 * niter * 128 * n_rows
    ops_ms = flops / FP32_OPS_PER_S * 1e3
    bytes_ms = 2 * n_rows * 128 * 4 / HBM_BYTES_PER_S * 1e3
    log(f"fma_chain at [{n_rows}, 128], niter {niter}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {max(ops_ms, bytes_ms):.4f} ms "
        f"({flops:.3e} FP32 FLOPs; bytes {bytes_ms:.4f} ms), "
        f"{ops_ms / ms:.1%} of the FP32 peak")

    # -- 7c. the card's own nvidia-smi under the load (information) ----------
    niter_10ms = max(1, int(round((SMI_HALF_S * 1e3 - intercept) / slope)))
    launches_0 = fma_chain.launches
    smi = smi_load(dev, x, niter_10ms)
    launches_7c = fma_chain.launches - launches_0
    launches = fma_chain.launches
    check(launches_7c > 0, "the nvidia-smi load ran no fma_chain kernel")
    log(f"nvidia-smi under fma_chain (niter {niter_10ms} ~ 10 ms): "
        f"{smi['readings']} readings of {smi['fields'][1:]}, poll interval "
        f"{smi['poll_interval_ms']:.3f} ms; update period (median complete "
        f"run, 8 s square wave): " + " ".join(
            f"{k} {v * 1e3:.1f} ms ({smi['complete_runs'][k]} runs)"
            for k, v in smi["update_period_s"].items()))
    for k, watts in smi["plateaus_w"].items():
        log(f"  Fig. 8 plateaus, mean {k} over the second half of each: " + " ".join(
            f"{f}: {w:.2f} W" for f, w in zip(FMA_FRACTIONS, watts)))

    # -- 7d. characterise on the card and on the CPU --------------------------
    k_log.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = characterisation(dev)
    torch.cuda.synchronize()
    char_s = time.perf_counter() - t0
    lf_7d = log_filter.launches
    check(lf_7d > 0, "the characterisation ran no log_filter kernel")
    t0 = time.perf_counter()
    cpu = characterisation(torch.device("cpu"))
    char_cpu_s = time.perf_counter() - t0
    a100, v100 = card["a100"], card["v100"]
    check(near(a100.update_period_s, 0.100, 0.1)
          and near(a100.sampled_fraction, 0.25, 0.35)
          and abs(a100.gain - card["a100_true_gain"]) <= 0.015,
          f"a100 characterisation off: {a100}")
    check(near(v100.sampled_fraction, 0.5, 0.35),
          f"v100 characterisation off: {v100}")
    avg = card["rtx3090_average"].transient
    check(avg.kind == "linear" and 0.6 < avg.rise_time_s < 1.2,
          f"rtx3090_average transient off: {avg}")
    check(card["kepler"].kind == "logarithmic",
          f"kepler transient off: {card['kepler']}")
    for name, want in CHAR_PERIODS:
        got = card[f"period_{name}"]
        check(near(got, want, 0.15),
              f"{name} update period {got} (want {want})")
    (n_card, k_card), (n_cpu, k_cpu) = char_numbers(card), char_numbers(cpu)
    check(k_card == k_cpu, f"transient kinds: card {k_card}, CPU {k_cpu}")
    worst = 0.0
    for got, want in zip(n_card, n_cpu):
        if math.isnan(want):
            check(math.isnan(got), "characterisation: card number vs nan")
            continue
        rel = abs(got - want) / max(abs(want), 1e-300)
        worst = max(worst, rel)
        check(rel <= 1e-9, f"characterisation: card {got!r} vs CPU {want!r}")
    log(f"characterisation on the card in {char_s:.3f} s (CPU {char_cpu_s:.3f}"
        f" s): a100 T {a100.update_period_s * 1e3:.2f} ms, W "
        f"{a100.window_s * 1e3:.2f} ms, sampled {a100.sampled_fraction:.3f}, "
        f"gain {a100.gain:.5f} (true {card['a100_true_gain']:.5f}), offset "
        f"{a100.offset_w:.3f} W, R^2 {a100.r2:.6f}; v100 sampled "
        f"{v100.sampled_fraction:.3f}; rtx3090_average {avg.kind} rise "
        f"{avg.rise_time_s:.3f} s; kepler {card['kepler'].kind}; periods "
        + " ".join(f"{n} {card[f'period_{n}'] * 1e3:.2f} ms"
                   for n, _ in CHAR_PERIODS)
        + f"; card matches the CPU (kinds equal, largest relative difference "
        f"{worst:.3e}); {lf_7d} log_filter launches")

    # -- 7e. the calibration store, then a calibrated §5 measurement ---------
    step_integrate.launches = 0
    with tempfile.TemporaryDirectory() as root:
        store = CalibrationStore(root)
        rec = store.get_or_characterise(
            "card0", OnboardSensor(profiles.get("v100"), seed=4, device=dev),
            GroundTruthMeter(seed=5, device=dev))
        again = CalibrationStore(root).get("card0")
    check(again == rec, f"calibration record reloaded as {again}, written "
          f"as {rec}")
    check(near(rec.update_period_s, 0.020, 0.2),
          f"stored update period {rec.update_period_s}")
    prof = profiles.get("rtx3090_instant")
    sensor = OnboardSensor(prof, seed=77, device=dev)
    ss = mb.estimate_steady_state(sensor, GroundTruthMeter(seed=8,
                                                           device=dev))

    def calib(gain=None, offset=None):
        return CalibrationRecord("d0", prof.name, prof.update_period_s,
                                 prof.window_s, "instant", 0.25, gain=gain,
                                 offset_w=offset,
                                 sampled_fraction=prof.sampled_fraction)
    wl = pm.Workload("burst", loads.workload_burst(0.200, 230.0))
    plain = pm.measure_good_practice(sensor, wl, calib(),
                                     pm.GoodPracticeConfig(), seed=3)
    cal = pm.measure_good_practice(
        sensor, wl, calib(ss.gain, ss.offset_w),
        pm.GoodPracticeConfig(apply_calibration=True), seed=3)
    torch.cuda.synchronize()
    step_7e = step_integrate.launches
    check(step_7e > 0, "the calibrated measurement ran no step_integrate")
    e_plain = abs(plain.error_vs(wl.true_energy_j))
    e_cal = abs(cal.error_vs(wl.true_energy_j))
    check(e_cal <= e_plain + 0.01, f"calibration made the §5 error worse: "
          f"{e_cal:.4%} vs {e_plain:.4%}")
    log(f"calibration store: v100 record written and reloaded equal (T "
        f"{rec.update_period_s * 1e3:.2f} ms, {rec.transient_kind}); "
        f"rtx3090_instant gain {ss.gain:.5f} (true {sensor.true_gain:.5f}), "
        f"offset {ss.offset_w:.3f} W: §5 error {e_plain:.3%} uncalibrated, "
        f"{e_cal:.3%} calibrated; {step_7e} step_integrate launches")
    return dict(
        name="fma_chain", route="cuda",
        source=f"src/repro_torch/kernels/csrc/{_build.SOURCES['fma_chain']}",
        replaces=REPLACES["fma_chain"], launches=launches,
        max_abs_err=max(err, small_err), ms=ms, plain_ms=plain_ms,
        bound_ms=max(ops_ms, bytes_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None, shape=[n_rows, 128], niter=niter, flops=flops,
        launches_7b=launches_7b, launches_7c=launches_7c,
        niters=list(FMA_NITERS), ms_by_niter=by_niter,
        slope_ms_per_iter=float(slope), intercept_ms=float(intercept),
        r2=float(r2), fractions=list(FMA_FRACTIONS), ms_by_fraction=by_frac,
        sass_loop=dict(instructions=n_ins, ffma=n_ffma, others=others),
        nvidia_smi=smi, characterise_s=char_s,
        characterise_cpu_s=char_cpu_s), dict(launches_7d=lf_7d), dict(
        launches_7e=step_7e)


# ---------------------------------------------------------------------------
# recurrentgemma-9b serving
# ---------------------------------------------------------------------------
def rglru_cases(dev):
    """rglru_scan inputs on ``dev``: ragged and tiny shapes, decays in
    (0, 1), exactly 1 and above 1, f32 and bf16 u; then the main path's
    [2, 3000, 4096] f32.  Returns (label, a, u) triples."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 29)

    def case(b, s, d, dtype=torch.float32, edges=True):
        a = torch.sigmoid(torch.randn((b, s, d), generator=gen, device=dev))
        if edges:
            a[..., : d // 4] = 1.0
            a[..., d // 4: d // 3] *= 1.3
        u = torch.randn((b, s, d), generator=gen, device=dev)
        return (f"[{b}, {s}, {d}] {str(dtype)[6:]}", a, u.to(dtype))
    return [case(1, 1, 1), case(3, 17, 5), case(2, 100, 513),
            case(1, 257, 64, torch.bfloat16), case(2, 64, 96, torch.float16),
            case(*LM_SCAN_SHAPE, edges=False)]


def rglru_check(a, u):
    """The kernel against its plain version on the same card inputs,
    bitwise; returns the largest absolute difference (0.0)."""
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    got = rglru_scan(a, u)
    want = rglru_scan_plain(a, u)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"rglru_scan output {got.dtype}{tuple(got.shape)}, plain "
          f"{want.dtype}{tuple(want.shape)}")
    err = float((got.float() - want.float()).abs().max())
    check(torch.equal(got, want), f"rglru_scan at {list(a.shape)} "
          f"{u.dtype}: not bitwise equal to the plain version (largest "
          f"difference {err:.3e})")
    return err


def flash_cases(dev):
    """flash_attention inputs on ``dev``: tests/test_kernels.py's shapes
    (GQA, MQA, ragged, non-causal, window, soft-cap, S != T), an odd
    group and head_dim, a 128-head group, rows with no valid key, the
    main path's shape at small S (300, and 299: the last 128-row block
    holds 3 positions), and head_dims 128 (GQA), 80 (MQA) and 192 (the
    kernels' DMAX = 128 and 256 instances below their full width), each
    in f32, f16 and bf16; then the main path's own shape.  Returns that
    list of (label, q, k, v, kwargs), and a second one: a head_dim of 40
    in f16 and bf16, the 16-bit inputs that stay on the CUDA cores."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)

    def case(b, s, t, hq, hkv, d, dtype=torch.float32, **kw):
        q, k, v = (torch.randn((b, n, h, d), generator=gen,
                               device=dev).to(dtype)
                   for n, h in ((s, hq), (t, hkv), (t, hkv)))
        label = (f"q [{b}, {s}, {hq}, {d}] k [{b}, {t}, {hkv}, {d}] "
                 f"{str(dtype)[6:]} {kw}")
        opts = dict(causal=True, window=0, softcap=0.0)
        opts.update(kw)
        return label, q, k, v, opts
    out = []
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        out += [case(2, 64, 64, 4, 4, 32, dtype),
                case(2, 100, 100, 4, 2, 32, dtype),
                case(2, 64, 64, 8, 1, 16, dtype),
                case(2, 64, 64, 4, 2, 32, dtype, causal=False),
                case(2, 96, 96, 2, 2, 32, dtype, window=17),
                case(2, 64, 64, 2, 2, 32, dtype, softcap=20.0),
                case(2, 32, 128, 2, 2, 32, dtype, causal=False),
                case(1, 50, 50, 6, 2, 48, dtype, window=9, softcap=5.0),
                case(1, 40, 40, 128, 1, 64, dtype),
                case(1, 64, 16, 4, 2, 32, dtype, window=8),
                case(1, 70, 70, 4, 1, 256, dtype, causal=False, window=20),
                case(2, 300, 300, 16, 1, 256, dtype, window=64),
                case(2, 299, 299, 16, 1, 256, dtype, window=64),
                case(1, 64, 64, 4, 2, 32, dtype, softcap=30.0),
                case(2, 100, 100, 8, 2, 128, dtype, window=33),
                case(1, 130, 130, 16, 1, 80, dtype, window=64),
                case(1, 129, 129, 4, 1, 192, dtype)]
    b, s, hq, hkv, d = LM_ATTN_SHAPE
    out.append(case(b, s, s, hq, hkv, d, torch.bfloat16,
                    window=LM_WINDOW))
    odd_d = [case(1, 50, 50, 4, 2, 40, dtype, window=9)
             for dtype in (torch.float16, torch.bfloat16)]
    return out, odd_d


def flash_close(got, want, what):
    """``got`` within FLASH_TOL of its type of ``want`` (absolute and
    relative, the reference tests' tolerances) and finite.  Returns the
    largest absolute difference and the relative L2 difference."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: output {got.dtype}{tuple(got.shape)}, plain "
          f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
    tol = FLASH_TOL[got.dtype]
    bad = (g - w).abs() > tol + tol * w.abs()
    check(not bool(bad.any()) and bool(torch.isfinite(g).all()),
          f"{what}: {int(bad.sum())} outputs off by more than {tol:g} "
          f"(largest {err:.3e})")
    return err, rel


def flash_check(q, k, v, kw):
    """The kernel against blocked_attention on the same card inputs
    (:func:`flash_close`), on the route its type and head_dim take:
    bf16/f16 with head_dim a multiple of 16 on the tensor cores, the rest
    on the CUDA cores.  Returns the largest absolute and the relative L2
    difference."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models.layers import blocked_attention
    d = q.shape[3]
    want_route = (kfa.CUDA_CORES if q.dtype == torch.float32 or d % 16
                  else kfa.TENSOR_CORES)
    before = dict(kfa.flash_attention.launches_by_route)
    got = kfa.flash_attention(q, k, v, **kw)
    before[want_route] += 1
    check(kfa.flash_attention.launches_by_route == before,
          f"flash_attention at q {list(q.shape)} {q.dtype}: launches by "
          f"route {kfa.flash_attention.launches_by_route}, expected one "
          f"more on {want_route}")
    want = blocked_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    return flash_close(got, want, f"flash_attention at q {list(q.shape)} "
                       f"k {list(k.shape)} {q.dtype} {kw}")


def attention_pairs(s, t, window, causal=True):
    """(query, key) pairs the masks keep, per (batch, head)."""
    q = np.arange(s)[:, None]
    k = np.arange(t)[None, :]
    keep = (k <= q) if causal else np.ones((s, t), bool)
    if window > 0:
        keep &= k > q - window
    return int(keep.sum())


def flash_tc_work(q, k, kw):
    """A model, from the shape alone, of what the tensor-core kernel
    executes, walking its blocks as csrc/flash_attention_tc.cu is written
    to (128 rows, 64-key tiles from the block's first visible key): the
    tiles, the FLOPs of its two products over them (padding rows, masked
    keys and the columns up to its instance's head_dim included) and the
    K/V bytes its TMA loads read, from L2 or from memory.  Nothing on the
    card counts these."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    gb = min(g, 128)
    bq = 128 // gb
    dmax = 64 if d <= 64 else 128 if d <= 128 else 256
    i0 = np.arange(0, s, bq)
    q_hi = np.minimum(i0 + bq, s) - 1
    k_begin = (np.maximum(0, i0 - kw["window"] + 1) if kw["window"] > 0
               else np.zeros_like(i0))
    k_end = np.minimum(t, q_hi + 1) if kw["causal"] else np.full_like(i0, t)
    tiles = np.where(k_end > k_begin, (k_end - k_begin + 63) // 64, 0)
    n = int(tiles.sum()) * -(-g // gb) * hkv * b
    return n, n * 4 * 128 * 64 * dmax, n * 2 * 64 * dmax * q.element_size()


def flash_cuda_cores_ms(q, k, v, kw, want):
    """The CUDA-core kernel on the same 16-bit inputs, the route they took
    before the tensor-core kernel, launched through the wrapper's own
    launch (the wrapper sends them to the tensor cores; this counts no
    launch): its time, and its largest absolute and relative L2
    difference from ``want``, blocked_attention's output, within
    FLASH_TOL."""
    from repro_torch.kernels import flash_attention as kfa
    out = torch.empty_like(q)
    ms = time_ms(lambda: kfa._launch_route(kfa.CUDA_CORES, q, k, v, out,
                                           **kw), 3)
    return (ms, *flash_close(out, want, f"the CUDA-core flash_attention at "
                             f"q {list(q.shape)} {q.dtype} {kw}"))


def sdpa_ms(q, k, v, window):
    """``scaled_dot_product_attention``'s time on the same function: a
    causal sliding-window boolean mask, the KV head shared by the group
    (``enable_gqa``; where this PyTorch lacks it, K and V expanded to
    every head before the clock).  Returns (ms, largest difference from
    flash_attention's output, how the group's KV head was shared)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    s, t = q.shape[1], k.shape[1]
    pos_q = torch.arange(s, device=q.device)[:, None]
    pos_k = torch.arange(t, device=q.device)[None, :]
    mask = (pos_k <= pos_q) & (pos_k > pos_q - window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    g = q.shape[2] // k.shape[2]
    try:
        F.scaled_dot_product_attention(qt[:, :, :1], kt, vt,
                                       attn_mask=mask[:1], enable_gqa=True)
        extra, how = dict(enable_gqa=True), "enable_gqa"
    except TypeError:
        kt = kt.repeat_interleave(g, dim=1)
        vt = vt.repeat_interleave(g, dim=1)
        extra, how = {}, "K and V expanded"

    def run():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              **extra)
    ms = time_ms(run, 5)
    diff = float((run().transpose(1, 2).float() - flash_attention(
        q, k, v, window=window).float()).abs().max())
    return ms, diff, how


def lm_kernels(dev):
    """Phase 8a: both kernels against their plain versions on the card,
    then the main path's shapes timed.  Returns the two records (without
    launches)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    from repro_torch.models.layers import blocked_attention

    # full f32 products: TF32 would change the numbers held against the
    # plain versions and the CPU (matmuls default to off, cuDNN to on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scan = rglru_cases(dev)
    scan_err = max(rglru_check(a, u) for _, a, u in scan)
    log(f"rglru_scan vs plain, bitwise equal at {len(scan)} shapes: "
        + "; ".join(label for label, _, _ in scan))
    _, a, u = scan[-1]
    scan_shape = list(a.shape)
    scan_ms = time_ms(lambda: rglru_scan(a, u), 20)
    scan_plain_ms = time_ms(lambda: rglru_scan_plain(a, u), 1)
    scan_bytes = 3 * a.numel() * 4
    scan_bound = scan_bytes / HBM_BYTES_PER_S * 1e3
    log(f"rglru_scan at {scan_shape} f32: kernel {scan_ms:.4f} ms, plain "
        f"{scan_plain_ms:.3f} ms, bound {scan_bound:.4f} ms (bytes: "
        f"{scan_bytes:,}), {scan_bound / scan_ms:.1%} of it")

    flash, odd_d = flash_cases(dev)
    errs, wide = {}, {}
    kfa.reset_launches()
    for label, q, k, v, kw in flash:
        err, main_rel = flash_check(q, k, v, kw)
        errs[q.dtype] = max(errs.get(q.dtype, 0.0), err)
        if q.shape[3] in (80, 128, 192):
            wide[f"{str(q.dtype)[6:]} head_dim {q.shape[3]}"] = err
    tols = ", ".join(f"{str(t)[6:]} {v:g}" for t, v in FLASH_TOL.items())
    log(f"flash_attention vs blocked_attention at {len(flash)} shapes, "
        f"within {tols}; launches by route "
        f"{flash_attention.launches_by_route} (every 16-bit case on the "
        f"tensor cores); largest differences: " + ", ".join(
            f"{str(t)[6:]} {e:.3e}" for t, e in errs.items()))
    log("flash_attention at head_dim 80, 128 and 192 (the DMAX = 128 and "
        "256 instances below full width), largest differences: "
        + ", ".join(f"{k} {e:.3e}" for k, e in wide.items()))
    check(main_rel <= FLASH_MAIN_REL_L2, f"flash_attention at the main "
          f"shape: relative L2 difference {main_rel:.3e} from "
          f"blocked_attention, above {FLASH_MAIN_REL_L2:g}")
    kfa.reset_launches()
    odd_errs = {str(q.dtype)[6:]: flash_check(q, k, v, kw)[0]
                for _, q, k, v, kw in odd_d}
    check(flash_attention.launches_by_route[kfa.CUDA_CORES] == len(odd_d),
          f"16-bit head_dim 40: launches by route "
          f"{flash_attention.launches_by_route}")
    log(f"flash_attention's CUDA-core route with 16-bit inputs (head_dim "
        f"40, not a multiple of 16) vs blocked_attention: "
        + "; ".join(label for label, *_ in odd_d) + ", within FLASH_TOL, "
        f"largest differences {odd_errs}")
    _, q, k, v, kw = flash[-1]
    b, s, hq, d = q.shape
    main_route = kfa.route(q.dtype, d)
    fl_ms = time_ms(lambda: flash_attention(q, k, v, **kw), 20)
    want = blocked_attention(q, k, v, **kw)
    cc_ms, cc_err, cc_rel = flash_cuda_cores_ms(q, k, v, kw, want)
    del want
    fl_plain_ms = time_ms(lambda: blocked_attention(q, k, v, **kw), 1)
    lib_ms, lib_diff, lib_how = sdpa_ms(q, k, v, kw["window"])
    pairs = attention_pairs(s, s, kw["window"])
    flops = 4 * d * pairs * b * hq
    ops_ms = flops / BF16_OPS_PER_S * 1e3
    fl_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bytes_ms = fl_bytes / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    n_tiles, exec_flops, kv_bytes = flash_tc_work(q, k, kw)
    log(f"flash_attention at q [{b}, {s}, {hq}, {d}] k/v "
        f"{list(k.shape)} bf16, window {kw['window']}, route {main_route}: "
        f"kernel {fl_ms:.4f} ms, {bound / fl_ms:.1%} of the bound "
        f"{bound:.4f} ms ({pairs:,} pairs per head, {flops:.4e} FLOPs at "
        f"the bf16 tensor rate; bytes {bytes_ms:.4f} ms); relative L2 "
        f"difference from blocked_attention {main_rel:.3e} (at most "
        f"{FLASH_MAIN_REL_L2:g}); scaled_dot_product_attention "
        f"{lib_ms:.3f} ms ({lib_how}; largest difference {lib_diff:.3e}), "
        f"{lib_ms / fl_ms:.2f}x the kernel; the CUDA-core kernel on the "
        f"same inputs {cc_ms:.3f} ms (from blocked_attention: largest "
        f"difference {cc_err:.3e}, relative L2 {cc_rel:.3e}); plain "
        f"{fl_plain_ms:.3f} ms.  Modelled from the shape, not counted on "
        f"the card (flash_tc_work): {n_tiles:,} 64-key tiles of 128 rows, "
        f"{exec_flops:.4e} FLOPs ({exec_flops / fl_ms / 1e9:.1f} TFLOP/s "
        f"at the measured time), K/V through TMA {kv_bytes / 1e9:.3f} GB "
        f"({kv_bytes / fl_ms / 1e9:.2f} TB/s)")
    check(main_route == kfa.TENSOR_CORES, f"the main shape takes the "
          f"{main_route} route")
    src = "src/repro_torch/kernels/csrc/"
    return [
        dict(name="rglru_scan", route="cuda",
             source=src + _build.SOURCES["rglru_scan"],
             replaces=REPLACES["rglru_scan"], launches=0,
             max_abs_err=scan_err, ms=scan_ms, plain_ms=scan_plain_ms,
             bound_ms=scan_bound, bound_by="bytes", library_ms=None,
             shape=scan_shape, bytes=scan_bytes),
        dict(name="flash_attention", route="cuda",
             source=src + _build.SOURCES[kfa.KERNELS[main_route]],
             replaces=REPLACES["flash_attention"], launches=0,
             max_abs_err=max(errs.values()), ms=fl_ms, plain_ms=fl_plain_ms,
             bound_ms=bound,
             bound_by="operations" if ops_ms >= bytes_ms else "bytes",
             library_ms=lib_ms, main_route=main_route,
             routes={r: dict(source=src + _build.SOURCES[n], launches=0)
                     for r, n in kfa.KERNELS.items()},
             main_shape_rel_l2=main_rel, cuda_cores_ms=cc_ms,
             cuda_cores_max_abs_err=cc_err,
             max_abs_err_16_bit_cuda_cores=odd_errs,
             shape=[list(q.shape), list(k.shape)],
             window=kw["window"], pairs_per_head=pairs, flops=flops,
             max_abs_err_by_type={str(t)[6:]: e for t, e in errs.items()},
             library_max_abs_diff=lib_diff, library_call=(
                 f"scaled_dot_product_attention, boolean mask, {lib_how}"))]


def lm_serving(dev):
    """Phase 8; returns the records of rglru_scan and flash_attention."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServingEngine

    # -- 8a. the kernels against their plain versions -----------------------
    scan_rec, flash_rec = lm_kernels(dev)
    torch.cuda.empty_cache()

    # -- 8b. the main path: recurrentgemma-9b, full width and depth ----------
    cfg = get_config(LM_ARCH)
    kinds = cfg.layer_kinds()
    n_rglru = kinds.count("rglru")
    n_attn = sum(k.startswith("attn") for k in kinds)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = api.init_params(SEED + 37, cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 41)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen,
                         device=dev, dtype=torch.int32)
    log(f"{LM_ARCH}: {cfg.n_layers} layers ({n_rglru} rglru, {n_attn} "
        f"local attention, window {cfg.sliding_window}), d_model "
        f"{cfg.d_model}, {tf.param_count(cfg):,} parameters in "
        f"{cfg.param_dtype}, drawn on the card in {init_s:.2f} s")
    # warm-up: cuBLAS handles and every kernel's first launch
    warm = min(64, LM_PROMPT - 1)
    _, c = tf.prefill(params, cfg, {"tokens": toks[:, :warm]},
                      max_seq=LM_MAX_SEQ)
    api.decode_step(params, cfg, c, {"tokens": toks[:, warm:warm + 1],
                                     "pos": warm})
    del c
    torch.cuda.synchronize()

    rglru_scan.launches = 0
    kfa.reset_launches()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, cfg, {"tokens": toks},
                               max_seq=LM_MAX_SEQ)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    per_prefill = (rglru_scan.launches, flash_attention.launches)
    prefill_routes = dict(flash_attention.launches_by_route)
    check(tuple(logits.shape) == (LM_BATCH, LM_PROMPT, cfg.vocab)
          and logits.dtype == torch.float32, f"prefill logits "
          f"{logits.dtype}{tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    last = logits[:, -1].clone()
    del logits
    nxt = last.argmax(-1)
    generated, step_s = [], []
    for i in range(LM_DECODE):
        t0 = time.perf_counter()
        lg, cache = api.decode_step(params, cfg, cache, {
            "tokens": nxt[:, None].to(torch.int32), "pos": LM_PROMPT + i})
        nxt = lg[:, 0].argmax(-1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(lg).all()), f"decode step {i}: logits "
              f"not finite")
        generated.append(nxt.tolist())
    del cache
    eng = ServingEngine(cfg, params, n_slots=LM_SERVE_SLOTS,
                        max_seq=LM_SERVE_MAX_SEQ, device=dev)
    reqs = [Request(i, torch.randint(0, cfg.vocab, (LM_SERVE_PROMPT,),
                                     generator=gen, device=dev).cpu().numpy(),
                    max_new_tokens=LM_SERVE_NEW)
            for i in range(LM_SERVE_REQUESTS)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = (rglru_scan.launches, flash_attention.launches)
    routes = dict(flash_attention.launches_by_route)
    peak = torch.cuda.max_memory_allocated(dev)
    ticks = eng.ticks
    check(len(done) == LM_SERVE_REQUESTS and all(
        r.done and len(r.generated) == LM_SERVE_NEW for r in reqs),
        f"ServingEngine answered {len(done)} of {LM_SERVE_REQUESTS}")
    check(per_prefill == (n_rglru, n_attn), f"a prefill launched rglru_scan "
          f"{per_prefill[0]} and flash_attention {per_prefill[1]} times, "
          f"not once per layer ({n_rglru}, {n_attn})")
    check(prefill_routes[kfa.TENSOR_CORES] == n_attn, f"a prefill's "
          f"flash_attention launches by route: {prefill_routes}, not all "
          f"{n_attn} on the tensor cores")
    check(launches == per_prefill and routes == prefill_routes,
          f"decode launched kernels: {launches}, {routes}")
    steps = sorted(step_s)
    log(f"8b main path: prefill {LM_BATCH} x {LM_PROMPT} tokens in "
        f"{prefill_s:.3f} s ({LM_BATCH * LM_PROMPT / prefill_s:,.0f} "
        f"tokens/s); {LM_DECODE} greedy decode steps, median "
        f"{steps[len(steps) // 2] * 1e3:.2f} ms (min {steps[0] * 1e3:.2f}, "
        f"max {steps[-1] * 1e3:.2f}); tokens per row "
        f"{[[g[b] for g in generated] for b in range(LM_BATCH)]}; "
        f"ServingEngine, {LM_SERVE_SLOTS} slots, {LM_SERVE_REQUESTS} requests "
        f"of {LM_SERVE_PROMPT} + {LM_SERVE_NEW} tokens: {ticks} ticks in "
        f"{serve_s:.3f} s, tokens {[r.generated for r in reqs]}; launches "
        f"rglru_scan {launches[0]}, flash_attention {launches[1]} {routes}; "
        f"peak "
        f"memory {peak / 1e9:.2f} GB")

    # -- 8b. prefill(S-1) + decode_step against prefill(S) -------------------
    rglru_scan.launches = 0
    kfa.reset_launches()
    lg, c = tf.prefill(params, cfg, {"tokens": toks[:, :-1]},
                       max_seq=LM_MAX_SEQ)
    del lg
    lg, _ = api.decode_step(params, cfg, c, {"tokens": toks[:, -1:],
                                             "pos": LM_PROMPT - 1})
    del c
    dec = lg[:, 0]
    rel = float(torch.linalg.vector_norm(dec - last)
                / torch.linalg.vector_norm(last))
    same = bool(torch.equal(dec.argmax(-1), last.argmax(-1)))
    log(f"prefill({LM_PROMPT - 1}) + decode_step vs prefill({LM_PROMPT}): "
        f"relative L2 of the last logits {rel:.3e}, argmax "
        f"{dec.argmax(-1).tolist()} vs {last.argmax(-1).tolist()}")
    check(same and rel < LM_CONSISTENCY_REL, f"prefill + decode_step "
          f"disagrees with prefill: relative L2 {rel:.3e}, argmax equal "
          f"{same}")
    del params, eng
    torch.cuda.empty_cache()

    # -- 8c. the reduced model in float32, card against CPU ------------------
    red = lm_reduced(dev)
    cpu = lm_reduced(torch.device("cpu"))
    worst = {}
    for key in ("forward", "prefill", "decode"):
        a, b = red[key], cpu[key]
        err = float((a - b).abs().max())
        worst[key] = err
        check(err <= LM_REDUCED_TOL * float(b.abs().max()),
              f"reduced {key} logits: card vs CPU off by {err:.3e}")
    check(red["serve"] == cpu["serve"], f"reduced ServingEngine tokens: "
          f"card {red['serve']}, CPU {cpu['serve']}")
    log("8c reduced recurrentgemma-9b, float32, card vs CPU: largest "
        "logit differences " + ", ".join(f"{k} {v:.3e}"
                                         for k, v in worst.items())
        + f" (within {LM_REDUCED_TOL:g} x max|logit|); ServingEngine "
        f"tokens equal: {red['serve']}")

    extra = dict(prefill_s=prefill_s, decode_ms=[t * 1e3 for t in step_s],
                 serve_s=serve_s, serve_ticks=ticks,
                 peak_memory_bytes=peak, consistency_rel_l2=rel,
                 reduced_max_abs_diff=worst)
    scan_rec.update(launches=launches[0], **extra)
    flash_rec.update(launches=launches[1])
    for r, n in routes.items():
        flash_rec["routes"][r]["launches"] = n
    return [scan_rec, flash_rec]


def lm_reduced(dev):
    """Phase 8c on ``dev``: recurrentgemma-9b's REDUCED config in float32,
    weights drawn on the CPU from one seed; forward over 40 tokens (past
    the 16-token window), prefill(39) + decode_step, and a 2-slot
    ServingEngine answering 3 requests."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServingEngine
    cfg = get_config(LM_ARCH, reduced=True).replace(param_dtype="float32")
    params = tf.map_tree(lambda _, x: x.to(dev),
                         api.init_params(SEED + 43, cfg, "cpu"))
    rng = np.random.default_rng(SEED + 47)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)),
                           dtype=torch.int32, device=dev)
    logits, _ = api.forward(params, cfg, {"tokens": toks})
    pre, cache = tf.prefill(params, cfg, {"tokens": toks[:, :-1]},
                            max_seq=48)
    dec, _ = api.decode_step(params, cfg, cache, {"tokens": toks[:, -1:],
                                                  "pos": 39})
    eng = ServingEngine(cfg, params, n_slots=2, max_seq=32, device=dev)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=6) for i, n in enumerate((5, 8, 3))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return dict(forward=logits.cpu(), prefill=pre.cpu(),
                decode=dec[:, 0].cpu(), serve=[r.generated for r in reqs])


def near(got, want, rel):
    """``got`` within ``rel`` of ``want``, relatively (the reference tests'
    ``pytest.approx(want, rel=rel)``); false for nan."""
    return abs(got - want) <= rel * abs(want)


if __name__ == "__main__":
    sys.exit(main())
