"""The fleet audit's cells: ``fleet_audit`` over a mixed fleet, as its
users call it: the profile names, a ``FleetScenarioSpec`` and a seed.
Scenario synthesis, the sensor simulation, the keyed stream and §5 are
the program's work, and timed.

Set-up builds nothing (the audit runs no hand kernel at these profiles)
and runs a warm-up audit of ``warmup_devices`` in the cell's slab size.
The window then runs whole audits back to back, audit ``k`` at seed
``--seed + 1 + k``, and closes at the end of the audit in progress once
``--seconds`` have passed.  ``audit_devices_per_s`` is every device of
the window's audits over the window's time.  With ``--trace 1`` the
window's first audit runs under the profiler.

After each audit ``sample_per_audit`` rows drawn from the seed are kept;
after the window the plain reference (:mod:`portbench.reference.audit`)
works out those rows' answers from the seed alone.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import harness, trace
from portbench.reference import compare
from portbench.reference.audit import AuditReference, fleet_names

KEYS = ("true_j", "naive_j", "gp_j", "naive_err", "gp_err")


def sample_rows(seed: int, k: int, n: int, size: int) -> np.ndarray:
    """Audit ``k``'s checked rows, drawn from the run's seed."""
    rng = np.random.default_rng([int(seed), int(k)])
    return np.sort(rng.choice(n, size=min(size, n), replace=False))


def run(cell: harness.Cell, t0: float, fault=None) -> harness.Outcome:
    """One run of an audit cell.  ``fault`` (tests only) wraps
    ``fleet_audit`` to break the timed path."""
    from repro_torch.core.fleet_engine import fleet_audit
    from repro_torch.core.load import FleetScenarioSpec

    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    n = int(cfg["n_devices"])
    gp = cfg["good_practice"]
    entry = fleet_audit if fault is None else fault(fleet_audit)

    def audit(n_dev: int, seed: int):
        spec = FleetScenarioSpec(n_dev, mix=dict(cfg["scenario_mix"]),
                                 seed=seed, idle_w=float(cfg["idle_w"]),
                                 peak_w=float(cfg["peak_w"]))
        with trace.span("audit"):
            return entry(n_dev, fleet_names(cfg, n_dev),
                         workload=spec, seed=seed, good_practice=True,
                         n_trials=int(gp["n_trials"]),
                         chunk_devices=int(cfg["chunk_devices"]),
                         prefetch_workloads=bool(cfg["prefetch"]),
                         device=dev)

    t_ready = time.perf_counter()
    audit(min(int(tr["warmup_devices"]), n), cell.seed)
    if cell.trace:              # the profiler's own start-up, out of the window
        with torch.profiler.profile():
            torch.zeros(1, device=dev).add_(1)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    print(f"portbench: set-up {setup_s:.3f} s: to the warm-up "
          f"{t_ready - t0:.3f}, warm-up audit {setup_s - (t_ready - t0):.3f}",
          file=sys.stderr)

    kept, walls, devices, k = [], [], 0, 0
    prof = None
    start = time.perf_counter()
    deadline = start + cell.seconds
    while True:
        began = time.perf_counter()
        seed = cell.seed + int(tr["seed_step"]) * (k + 1)
        if cell.trace and k == 0:
            with trace.Profiled(cuda) as prof:
                res = audit(n, seed)
        else:
            res = audit(n, seed)
        rows = sample_rows(cell.seed, k, n, int(tr["sample_per_audit"]))
        at = torch.as_tensor(rows, device=res.naive_j.device)
        got = {key: getattr(res, key)[at] for key in KEYS}
        kept.append((seed, rows, got))
        devices += n
        k += 1
        del res
        walls.append(time.perf_counter() - began)
        if time.perf_counter() >= deadline:
            break
    if cuda:
        torch.cuda.synchronize(dev)
    end = time.perf_counter()
    print("portbench: audits of " + ", ".join(f"{w:.3f}" for w in walls)
          + " s", file=sys.stderr)

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    traced = prof.read(harness.trace_path(cell)) if prof is not None else None
    if cuda:
        torch.cuda.empty_cache()
    ref = AuditReference(cfg, torch.float64, dev)
    values = check(ref, kept)
    limits = harness.limits(cell)
    checks = {key: (values[key], float(limits[key])) for key in values}
    return harness.Outcome(
        attempted=k, failed=0,
        metrics={"audit_devices_per_s": devices / (end - start),
                 "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, device_kind=kind,
        device_count=1,
        trace=(harness.TraceContext(traced, {"devices_traced": n})
               if traced is not None else None))


def check(ref: AuditReference, kept) -> dict:
    """The audit's numbers: the widest gap of the sampled energies (truth,
    naive, §5) and of the two errors against the reference's."""
    gaps = {"energy_gap": [], "error_gap": []}
    for seed, rows, got in kept:
        want = ref.audit(seed, rows)
        for key in KEYS:
            name = "error_gap" if key.endswith("_err") else "energy_gap"
            gaps[name].append(compare.rel_gap(got[key], want[key]))
    return {name: compare.worst(v) for name, v in gaps.items()}
