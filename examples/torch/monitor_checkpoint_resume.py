"""Kill a live fleet monitor mid-stream, restore it, and keep serving, on
the card (the port of ``examples/monitor_checkpoint_resume.py``).

A mixed-scenario fleet streams poll slabs into a ``MonitorService``
while a ``MonitorQueryService`` answers batched dashboard queries against
its immutable snapshots.  Halfway through, the monitor is checkpointed
(``save_monitor``: one step per ingest epoch, the reference's
atomic-rename manifest layout) and thrown away; a *restored* monitor
ingests the remaining slabs and the demo verifies that every query
answer is bitwise identical to an uninterrupted run.

    PYTHONPATH=src python examples/torch/monitor_checkpoint_resume.py
        [n_devices] [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import load as loads
from repro_torch.core.fleet_engine import SensorBank
from repro_torch.core.stream import (MonitorService, restore_monitor,
                                     save_monitor)
from repro_torch.serve.monitor_service import (MonitorQuery,
                                               MonitorQueryService)


def _np(x):
    return x.detach().cpu().numpy()


def poll_slabs(n, device):
    names = (["a100"] * (n // 2) + ["h100_instant"] * (n // 4)
             + ["v100"] * (n - n // 2 - n // 4))
    ws = loads.mixed_fleet_workloads(n, seed=7, as_bank=True, device=device)
    bank = SensorBank.from_catalog(names, seed=0, device=device)
    tlb = ws.timeline_bank
    tlb = tlb.shift(0.3 - tlb.t_start)
    bank.attach(tlb, t_end=tlb.t_end + 1.0)
    t1 = float(tlb.t_end.max()) + 0.5
    return list(bank.iter_poll_slabs(0.0, t1, period_s=0.005, tick_s=0.5,
                                     grid=True))


def serve_some(svc, t_hi):
    qs = [MonitorQuery.fleet_energy(t) for t in
          np.linspace(0.1, max(t_hi - 0.1, 0.1), 16)]
    qs += [MonitorQuery.fleet_energy(), MonitorQuery.by_label(),
           MonitorQuery.energy_between(0.2, max(t_hi - 0.2, 0.2))]
    tickets = [svc.submit(q) for q in qs]
    res = svc.flush()
    return res[tickets[-3]]          # the since-start FleetEnergy


def run(n=2_000, device="cuda", ckpt_dir=None):
    """Stream, checkpoint, restore, check and print; returns the printed
    numbers."""
    dev = resolve_device(device)
    slabs = poll_slabs(n, dev)
    half = len(slabs) // 2
    print(f"{n} devices, {len(slabs)} poll slabs "
          f"({sum(v.numel() for _, _, v in slabs)} samples)")

    # --- uninterrupted reference run -----------------------------------
    ref = MonitorService(n, ring_slots=8, device=dev)
    for d, ts, vals in slabs:
        ref.ingest_grid(d, ts, vals)

    # --- live run: ingest + serve, checkpoint at a slab boundary -------
    live = MonitorService(n, ring_slots=8, device=dev)
    svc = MonitorQueryService(live)
    t_hi = 0.0
    for d, ts, vals in slabs[:half]:
        live.ingest_grid(d, ts, vals)
        t_hi = max(t_hi, float(ts[-1]))
        fe = serve_some(svc, t_hi)
    stats = svc.stats()
    print(f"served while ingesting: {stats['n_answered']} queries, "
          f"cache hit rate {stats['cache_hit_rate']:.2f}, "
          f"fleet so far {fe.total_j / 1e3:.1f} kJ")

    ckpt = ckpt_dir or tempfile.mkdtemp(prefix="monitor_ckpt_")
    t0 = time.perf_counter()
    save_monitor(live, ckpt)
    save_ms = (time.perf_counter() - t0) * 1e3
    epoch = live.epoch
    print(f"checkpointed epoch {epoch} -> {ckpt} ({save_ms:.0f} ms)")
    del live, svc                    # "the process died here"

    # --- restore and finish the stream ---------------------------------
    resumed = restore_monitor(ckpt, device=dev)
    svc = MonitorQueryService(resumed)
    print(f"restored at epoch {resumed.epoch}; resuming stream")
    for d, ts, vals in slabs[half:]:
        resumed.ingest_grid(d, ts, vals)
        t_hi = max(t_hi, float(ts[-1]))
        serve_some(svc, t_hi)

    # --- bitwise parity with the uninterrupted run ---------------------
    checks = {
        "fleet_energy": (ref.fleet_energy().per_device_j,
                         resumed.fleet_energy().per_device_j),
        "energy_between": (ref.energy_between(0.5, t_hi - 0.5)[0],
                           resumed.energy_between(0.5, t_hi - 0.5)[0]),
        "window_energy": (ref.window_energy(t=t_hi - 0.3),
                          resumed.window_energy(t=t_hi - 0.3)),
        "update_period_s": (ref.update_period_s(),
                            resumed.update_period_s()),
    }
    equal = {}
    for name, (a, b) in checks.items():
        same = np.array_equal(_np(a), _np(b), equal_nan=True)
        equal[name] = same
        print(f"  {name:16s} bitwise equal: {same}")
        assert same, name
    assert ref.counters == resumed.counters
    final = resumed.fleet_energy()
    print("resume is bitwise-exact; final fleet "
          f"{final.total_j / 1e3:.1f} kJ over "
          f"{resumed.counters['accepted']} samples")
    return {"n_devices": n, "n_slabs": len(slabs),
            "n_samples": sum(v.numel() for _, _, v in slabs),
            "n_answered": stats["n_answered"],
            "cache_hit_rate": stats["cache_hit_rate"],
            "fleet_so_far_j": fe.total_j, "epoch": epoch,
            "save_ms": save_ms, "ckpt_dir": ckpt, "bitwise_equal": equal,
            "counters": dict(resumed.counters),
            "final_j": final.total_j,
            "per_device_j": _np(final.per_device_j)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_devices", nargs="?", type=int, default=2_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    args = ap.parse_args(argv)
    return run(args.n_devices, resolve_device(args.device), args.ckpt_dir)


if __name__ == "__main__":
    main()
