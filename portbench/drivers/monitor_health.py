"""The hardened monitor's cells: ``MonitorService(strict_ids=False,
health=HealthPolicy(...))`` as the configuration deploys it, over the
fleet's readings sent through the source's faults
(:class:`~portbench.gen.monitor_health.FaultyTraffic`).

Closed loop through ``MonitorService.ingest``, as the monitor driver
runs its flat cells: set-up builds the kernels, emits the faulted pool
and the warm-up slabs on the card, builds the monitor and ingests the
``warmup_slabs`` slabs in which the dying devices die.  The window then
ingests the stream's next slabs until ``--seconds`` have passed.
``ingest_samples_per_s`` is the samples the monitor accepted in the
window over the window's time, the final synchronisation included.  A
slab counts as failed when its report does not account for every sample
sent (accepted, duplicates, late, invalid and rejected), or when the
call raises.

After the window the monitor's state is read back and freed, and the
plain reference (:mod:`portbench.reference.monitor_health`) works out
what it must hold.  The comparison is the monitor cells'
(:func:`portbench.reference.compare.monitor`), with the ring read at its
own samples (each device's clock has its own rate and offset, so a
fleet-wide ``energy_between`` query falls outside nearly every ring), and
``state_mismatches`` counting besides every device's health code and
quarantine count and the ring's times and readings that differ.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import harness, trace
from portbench.counts import ingest as counts
from portbench.gen.monitor_health import FaultyTraffic
from portbench.reference import compare
from portbench.reference import monitor_health as reference

KERNEL = ("stream_ingest", "stream_ingest_kernel")
#: the ring's fields as the comparison names them
RING = (("t", "t"), ("v", "v"), ("e", "e_raw"), ("ec", "e_corr"))


def build_monitor(config: dict, gen: FaultyTraffic, device):
    """The program's hardened monitor as the configuration deploys it."""
    from repro_torch.core.stream import (HealthPolicy, MonitorService,
                                         StreamCorrections,
                                         default_calibrations)
    if config["corrections"] != "default_calibrations":
        raise ValueError(f"unknown corrections '{config['corrections']}'")
    if config["labels"] != "scenario":
        raise ValueError(f"unknown labels '{config['labels']}'")
    r = gen.readings
    corr = StreamCorrections.from_calibrations(
        r.names, default_calibrations(r.names),
        baseline_w=float(config.get("baseline_w", 0.0)), device=device)
    mon = MonitorService(
        r.n, corrections=corr, labels=np.array(r.labels, dtype=object),
        integration=config["integration"],
        ring_slots=int(config["ring_slots"]),
        period_bins=int(config["period_bins"]),
        min_runs=int(config["min_runs"]),
        strict_ids=bool(config["strict_ids"]),
        health=HealthPolicy(**config["health"]),
        health_every_s=float(config["health_every_s"]),
        silent_after_s=float(config["silent_after_s"]), device=device)
    mon.set_windows(r.win_a, r.win_b)
    return mon


def program_outputs(mon) -> dict:
    """What the comparison reads of the program, copied to the host."""
    st = mon.state
    out = {k: getattr(st, k).cpu() for k in compare.EXACT + (
        "energy_j", "energy_corr_j", "win_j", "win_corr_j")}
    out["period_est"] = mon.update_period_s().cpu()
    out["moments"] = mon.reading_stats()
    out["counters"] = dict(mon.counters)
    out["health_code"] = mon.health.code.cpu()
    out["n_quarantines"] = mon.health.n_quarantines.cpu()
    ring = mon.ring.sorted_view()
    out["ring"] = {k: x.cpu() for (k, _), x in zip(RING, ring)}
    return out


def checks(prog: dict, ref: dict, slots: int) -> dict:
    """The numbers that decide ``correct``: the monitor cells' (the ring's
    running energies in place of ``energy_between``), the health
    machine's and the ring's exact state among the state's mismatches.
    The ring is read on the devices that accepted at least ``slots``
    samples."""
    full = torch.as_tensor(ref["n_samples"]).cpu() >= slots

    def ring(side, k):
        return torch.as_tensor(side["ring"][k]).cpu()[full]
    both = []
    for side in (prog, ref):
        x = dict(side)
        x["between_raw"] = ring(side, "e").reshape(-1)
        x["between_corr"] = ring(side, "ec").reshape(-1)
        both.append(x)
    out = compare.monitor(*both)
    out["state_mismatches"] += float(sum(
        compare.mismatches(prog[k], ref[k])
        for k in ("health_code", "n_quarantines")) + sum(
        compare.mismatches(ring(prog, k), ring(ref, k)) for k in ("t", "v")))
    return out


def run(cell: harness.Cell, t0: float, fault=None) -> harness.Outcome:
    """One run of a hardened monitor cell.  ``fault`` (tests only) wraps
    the monitor's entry to break the timed path."""
    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg, tr = cell.config, cell.traffic
    if cuda:
        from repro_torch.kernels import _build
        _build.build(["stream_group", KERNEL[0]])
    t_built = time.perf_counter()
    gen = FaultyTraffic(cfg, tr, cell.seed, dev)
    sync()
    t_made = time.perf_counter()
    mon = build_monitor(cfg, gen, dev)
    entry = mon.ingest
    if fault is not None:
        entry = fault(entry, mon)
    tally = {"accepted": 0, "failed": 0, "sent": 0, "devices": 0}

    def one(i: int) -> None:
        with trace.span("traffic"):
            args = gen.slab(i)
        sent = args[0].numel()
        try:
            with trace.span("ingest"):
                rep = entry(*args)
        except (RuntimeError, ValueError) as exc:
            print(f"portbench: slab {i} raised {exc!r}", file=sys.stderr)
            tally["failed"] += 1
            return
        tally["accepted"] += rep.accepted
        tally["sent"] += sent
        tally["devices"] += rep.n_devices
        tally["failed"] += (rep.accepted + rep.duplicates + rep.late
                            + rep.invalid + rep.rejected) != sent

    i = 0
    for _ in range(int(tr["warmup_slabs"])):
        one(i)
        i += 1
    if cell.trace:      # the profiler's own start-up, out of the window
        with torch.profiler.profile():
            torch.zeros(1, device=dev).add_(1)
    sync()
    setup_s = time.perf_counter() - t0
    print(f"portbench: set-up {setup_s:.3f} s: to the kernels built "
          f"{t_built - t0:.3f}, traffic made {t_made - t_built:.3f}, "
          f"monitor and warm-up {setup_s - (t_made - t0):.3f}",
          file=sys.stderr)

    for k in tally:
        tally[k] = 0
    slabs = 0
    prof, traced, info = None, None, {}
    start = time.perf_counter()
    deadline = start + cell.seconds

    def step():
        nonlocal i, slabs
        one(i)
        i += 1
        slabs += 1

    if cell.trace:
        with trace.Profiled(cuda) as prof:
            for _ in range(int(tr["trace_slabs"])):
                step()
    after_trace, slabs_traced = time.perf_counter(), slabs
    traced_tally = dict(tally)
    # the reference rebuilds the stream from two slabs past the warm-up
    while time.perf_counter() < deadline or slabs < 2:
        step()
    sync()
    end = time.perf_counter()

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    if prof is not None:
        traced = prof.read(harness.trace_path(cell))
    prog = program_outputs(mon)
    del mon, entry
    gen.free()
    if cuda:
        torch.cuda.empty_cache()
    values = checks(prog, reference.expected(gen, i),
                    int(cfg["ring_slots"]))
    limits = harness.limits(cell)
    checks_ = {k: (values[k], float(limits[k])) for k in values}

    metrics = {"setup_s": setup_s,
               "ingest_samples_per_s": tally["accepted"] / (end - start)}
    if traced is not None:
        untraced = slabs - slabs_traced
        wall = ((end - after_trace) / untraced if untraced >= 10
                else traced.window_s / max(slabs_traced, 1))
        n_tr = max(slabs_traced, 1)
        k = traced_tally["accepted"] // n_tr
        u = traced_tally["devices"] // n_tr
        sent = traced_tally["sent"] // n_tr
        info = {"units_traced": slabs_traced, "wall_per_unit_s": wall,
                "sent_traced": traced_tally["sent"],
                "min_bytes_per_unit": counts.slab_min_bytes(
                    sent, u, 24, int(cfg["ring_slots"])),
                "kernels": {KERNEL[0]: {
                    "symbol": KERNEL[1], "bytes": counts.flat_kernel_bytes(
                        k, u), "ops": counts.flat_kernel_ops(k)}}}
        spent = traced.span_times("traffic")
        if spent:
            print(f"portbench: traffic {1e3 * sum(spent) / len(spent):.3f} "
                  f"ms a traced slab, {100 * sum(spent) / n_tr / wall:.2f}% "
                  f"of an untraced slab's wall", file=sys.stderr)
    return harness.Outcome(
        attempted=slabs, failed=tally["failed"],
        metrics=metrics, checks=checks_, memory_peak_bytes=peak,
        device_kind=kind, device_count=1,
        trace=(harness.TraceContext(traced, info) if traced is not None
               else None))
