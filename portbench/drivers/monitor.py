"""The streaming monitor's cells: ``MonitorService`` over a fleet whose
readings :class:`~portbench.gen.monitor.MonitorTraffic` makes on the card.

Closed loop: each slab goes in as the last returns, as a monitor catching
up on a backlog does; ``grid`` mixes through ``ingest_grid``, ``flat``
mixes through ``ingest``.  Set-up builds the kernel, makes the traffic
pool, builds the monitor and ingests ``warmup_slabs`` slabs of the stream.
The window then ingests the stream's next slabs until ``--seconds`` have
passed.  ``ingest_samples_per_s`` is every sample the monitor accepted in
the window over the window's time, the final synchronisation included.

With ``--trace 1`` the window's first ``trace_slabs`` slabs run under the
profiler; the rest of the window runs untraced and gives the wall time a
slab for ``ingest_step_hbm_pct``.

After the window the monitor's state is read back and freed, and the
plain reference (:mod:`portbench.reference.monitor`) works out what the
state must hold after every slab the run ingested.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import harness, trace
from portbench.counts import ingest as counts
from portbench.gen.monitor import MonitorTraffic
from portbench.reference import compare
from portbench.reference import monitor as reference

#: the hand kernel each layout's entry drives
KERNELS = {"grid": ("stream_ingest_grid", "stream_ingest_grid_kernel"),
           "flat": ("stream_ingest", "stream_ingest_kernel")}
#: the ring is read over [t_last - 6 ms, t_last - 1 ms]
BETWEEN_S = (0.006, 0.001)


def build_monitor(config: dict, gen: MonitorTraffic, device):
    """The program's monitor as the configuration deploys it."""
    from repro_torch.core.stream import (MonitorService, StreamCorrections,
                                         default_calibrations)
    if config["corrections"] != "default_calibrations":
        raise ValueError(f"unknown corrections '{config['corrections']}'")
    if config.get("health") is not None:
        raise ValueError("a monitor with health tracking needs its own "
                         "driver")
    if config["labels"] != "scenario":
        raise ValueError(f"unknown labels '{config['labels']}'")
    names = gen.names
    corr = StreamCorrections.from_calibrations(
        names, default_calibrations(names),
        baseline_w=float(config.get("baseline_w", 0.0)), device=device)
    mon = MonitorService(
        gen.n, corrections=corr, labels=np.array(gen.labels, dtype=object),
        integration=config["integration"],
        ring_slots=int(config["ring_slots"]),
        period_bins=int(config["period_bins"]),
        min_runs=int(config["min_runs"]), device=device)
    mon.set_windows(gen.win_a, gen.win_b)
    return mon


def program_outputs(mon, t_between) -> dict:
    """What the comparison reads of the program, copied to the host."""
    st = mon.state
    out = {k: getattr(st, k).cpu() for k in compare.EXACT + (
        "energy_j", "energy_corr_j", "win_j", "win_corr_j")}
    out["period_est"] = mon.update_period_s().cpu()
    out["moments"] = mon.reading_stats()
    out["counters"] = dict(mon.counters)
    for flavour, corrected in (("between_raw", False),
                               ("between_corr", True)):
        e, covered = mon.energy_between(*t_between, corrected=corrected)
        out[flavour] = torch.where(covered, e, float("nan")).cpu()
    return out


def run(cell: harness.Cell, t0: float, fault=None) -> harness.Outcome:
    """One run of a monitor cell.  ``fault`` (tests only) wraps the
    monitor's entry to break the timed path."""
    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg, tr = cell.config, cell.traffic
    layout = tr["layout"]
    kernel, kernel_symbol = KERNELS[layout]
    if cuda:
        from repro_torch.kernels import _build
        _build.build([kernel])
    t_built = time.perf_counter()
    gen = MonitorTraffic(cfg, tr, cell.seed, dev)
    sync()
    t_made = time.perf_counter()
    mon = build_monitor(cfg, gen, dev)
    entry = mon.ingest_grid if layout == "grid" else mon.ingest
    if fault is not None:
        entry = fault(entry, mon)
    expect = gen.samples_per_slab

    def one(i: int) -> int:
        with trace.span("traffic"):
            args = gen.slab(i)
        with trace.span("ingest"):
            return entry(*args).accepted

    i = 0
    for _ in range(int(tr["warmup_slabs"])):
        one(i)
        i += 1
    if cell.trace:              # the profiler's own start-up, out of the window
        with torch.profiler.profile():
            torch.zeros(1, device=dev).add_(1)
    sync()
    setup_s = time.perf_counter() - t0
    print(f"portbench: set-up {setup_s:.3f} s: to the kernel built "
          f"{t_built - t0:.3f}, traffic made {t_made - t_built:.3f}, "
          f"monitor and warm-up {setup_s - (t_made - t0):.3f}",
          file=sys.stderr)

    accepted = failed = slabs = 0
    prof, traced, info = None, None, {}
    start = time.perf_counter()
    deadline = start + cell.seconds

    def step():
        nonlocal i, slabs, accepted, failed
        got = one(i)
        i += 1
        slabs += 1
        accepted += got
        failed += got != expect

    if cell.trace:
        with trace.Profiled(cuda) as prof:
            for _ in range(int(tr["trace_slabs"])):
                step()
    after_trace, slabs_traced = time.perf_counter(), slabs
    while time.perf_counter() < deadline:
        step()
    sync()
    end = time.perf_counter()

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    if prof is not None:
        traced = prof.read(harness.trace_path(cell))
    t_last = gen.last_time(i - 1)
    t_between = (t_last - BETWEEN_S[0], t_last - BETWEEN_S[1])
    prog = program_outputs(mon, t_between)
    del mon, entry
    gen.flat = None
    if cuda:
        torch.cuda.empty_cache()
    values = compare.monitor(prog, reference.expected(gen, i, t_between))
    limits = harness.limits(cell)
    checks = {k: (values[k], float(limits[k])) for k in values}

    metrics = {"setup_s": setup_s,
               "ingest_samples_per_s": accepted / (end - start)}
    if traced is not None:
        untraced = slabs - slabs_traced
        wall = ((end - after_trace) / untraced if untraced >= 10
                else traced.window_s / max(slabs_traced, 1))
        d, m = gen.n, gen.m
        if layout == "grid":
            kb, ko = counts.grid_kernel_bytes(d, m), counts.grid_kernel_ops(
                d, m)
            need = counts.slab_min_bytes(d * m, d, 8, int(cfg["ring_slots"]),
                                         shared_times=m)
        else:
            k = gen.sent_per_slab
            kb, ko = counts.flat_kernel_bytes(k, d), counts.flat_kernel_ops(k)
            need = counts.slab_min_bytes(k, d, 24, int(cfg["ring_slots"]))
        info = {"units_traced": slabs_traced, "wall_per_unit_s": wall,
                "min_bytes_per_unit": need,
                "kernels": {kernel: {"symbol": kernel_symbol, "bytes": kb,
                                     "ops": ko}}}
    return harness.Outcome(
        attempted=slabs, failed=failed,
        metrics=metrics, checks=checks, memory_peak_bytes=peak,
        device_kind=kind, device_count=1,
        trace=(harness.TraceContext(traced, info) if traced is not None
               else None))
