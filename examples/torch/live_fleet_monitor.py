"""Monitor a mixed-scenario fleet *live* on the card (the port of
``examples/live_fleet_monitor.py``).

Replays a heterogeneous fleet — training pods, Poisson inference
serving, idle/maintenance, diurnal cycles — through the streaming
monitor tick by tick, printing the running naive vs §5-corrected fleet
energy and the convergence of the online update-period estimates, then
cross-checks the final window energies against the offline
``integrate_polled`` ground truth on the same reading schedules.

    PYTHONPATH=src python examples/torch/live_fleet_monitor.py
        [n_devices] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import load as loads
from repro_torch.core.stream import stream_fleet
from repro_torch.core.telemetry import FleetLedger


def _np(x):
    return x.detach().cpu().numpy()


def run(n=10_000, device="cuda"):
    """Stream, cross-check and print; returns the printed numbers."""
    dev = resolve_device(device)
    names = (["a100"] * (n // 2) + ["h100_instant"] * (n // 4)
             + ["v100"] * (n - n // 2 - n // 4))
    ws = loads.mixed_fleet_workloads(n, seed=7, as_bank=True, device=dev)

    print(f"streaming {n} devices (mixed scenarios) ...")
    last = {"t": 0.0}

    def progress(mon, t):
        if t - last["t"] < 0.25:
            return
        last["t"] = t
        naive_w = float(mon.window_energy(t=t, corrected=False).sum())
        corr_w = float(mon.window_energy(t=t, corrected=True).sum())
        sigma = mon.fleet_energy(corrected=True).sigma_worstcase_j
        conv = int(mon.update_period_s().isfinite().sum())
        print(f"  t={t:5.2f}s  window naive={naive_w/1e3:8.1f} kJ  "
              f"corrected={corr_w/1e3:8.1f} kJ (±{sigma/1e3:.1f})  "
              f"period-est converged: {conv}/{n}")

    t0 = time.perf_counter()
    res = stream_fleet(n, profile=names, workload=ws, seed=7,
                       compare=True, progress=progress, device=dev)
    wall = time.perf_counter() - t0
    mon = res.monitor

    print(f"\nstream done: {res.n_samples} samples in {wall:.1f} s "
          f"({res.n_samples / wall / 1e6:.2f} M samples/s), "
          f"monitor state {mon.nbytes() / 1e6:.0f} MB")

    dn = float(((res.naive_stream_j - res.naive_offline_j).abs()
                / res.naive_offline_j.abs()).max())
    dc = float(((res.corrected_stream_j - res.corrected_offline_j).abs()
                / res.corrected_offline_j.abs()).max())
    print(f"parity vs offline integrate_polled: naive {dn:.2e}, "
          f"corrected {dc:.2e} (max rel dev)")

    truth = ws.true_energies_j
    ne = float(((res.naive_stream_j - truth).abs() / truth).mean())
    ce = float(((res.corrected_stream_j - truth).abs() / truth).mean())
    print(f"mean abs error vs analytic truth: naive {ne * 100:.2f} %  ->  "
          f"corrected {ce * 100:.2f} %")

    that = _np(mon.update_period_s())
    print("\nonline update-period estimates (converged devices):")
    medians = {}
    for name in sorted(set(names)):
        sel = np.isfinite(that) & (np.asarray(names) == name)
        if np.any(sel):
            medians[name] = float(np.median(that[sel]))
            print(f"  {name:14s} median {medians[name] * 1e3:6.1f} ms"
                  f"  over {int(sel.sum())} devices")

    print("\nper-scenario energy (since stream start, incl. idle tails):")
    by_label = mon.by_label()
    for label, row in by_label.items():
        print(f"  {label:10s} n={row['n_devices']:6d}  "
              f"total={row['total_j'] / 1e3:8.1f} kJ  "
              f"mean={row['mean_j']:7.1f} J")

    flags = {k: int(v.sum()) for k, v in mon.flags().items()}
    print(f"\nhealth: {flags['silent']} silent, "
          f"{flags['anomalous']} anomalous, "
          f"{flags['drifting']} drifting")

    ledger = FleetLedger()
    ledger.register_monitor(mon)
    s = ledger.summary()
    print(f"ledger fold: {s.kwh:.2f} kWh ± {s.sigma_worstcase_j / 3.6e6:.2f} "
          f"(worst-case), ${s.cost_usd:.2f}")
    return {"n_devices": n, "n_samples": res.n_samples, "wall_s": wall,
            "nbytes": mon.nbytes(), "parity_naive": dn,
            "parity_corrected": dc, "naive_err": ne, "corrected_err": ce,
            "period_medians_s": medians, "by_label": by_label,
            "flags": flags, "kwh": s.kwh,
            "sigma_worstcase_j": s.sigma_worstcase_j,
            "cost_usd": s.cost_usd}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_devices", nargs="?", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.n_devices, resolve_device(args.device))


if __name__ == "__main__":
    main()
