"""Fleet energy audit at datacentre scale on the card, over a
heterogeneous fleet: every chip runs its own job (training pods, bursty
Poisson-arrival inference serving, idle/maintenance windows, diurnal
cycles), each with a part-time sensor carrying its own hidden
gain/offset/phase error.  The naive fleet energy bill is compared against
the §5 good-practice one, with the error broken down per workload
scenario (the port of ``examples/fleet_energy_audit.py``).

The audit runs through the batched engine
(:func:`repro_torch.core.fleet_engine.fleet_audit`): one ``SensorBank``
holds all the chips on the device, and every trial takes the whole
fleet's readings at once.

    PYTHONPATH=src python examples/torch/fleet_energy_audit.py
        [--device cpu] [--n-chips 4096]
"""
import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import FleetLedger, datacenter_projection
from repro_torch.core import load as loads
from repro_torch.core import profiles
from repro_torch.core.fleet_engine import fleet_audit


def run(n_chips=4096, device="cuda"):
    """Audit, account and print; returns the printed numbers."""
    dev = resolve_device(device)
    profile = profiles.get("tpu_v5e_chip")   # 25/100 part-time class

    # every chip its own timeline, drawn from the default scenario mix
    workloads = loads.mixed_fleet_workloads(n_chips, seed=1000, device=dev)

    t0 = time.perf_counter()
    res = fleet_audit(n_chips, profile=profile.name, workload=workloads,
                      seed=1000, good_practice=True, n_trials=2, device=dev)
    wall = time.perf_counter() - t0

    fleet = FleetLedger(price_usd_per_kwh=0.35)
    fleet.register_batch(res.gp_j, duration_s=float(np.mean(
        [w.duration_s for w in workloads])),
        labels=np.array(res.scenarios, dtype=object))
    s = fleet.summary()

    truth = float(res.true_j.sum())
    naive_total = float(res.naive_j.sum())
    print(f"chips audited        : {s.n_devices}  ({wall:.2f}s batched, "
          "every chip its own timeline)")
    print(f"true energy          : {truth:9.1f} J/rep")
    print(f"naive fleet reading  : {naive_total:9.1f} J/rep "
          f"({(naive_total-truth)/truth:+.1%})")
    print(f"good-practice total  : {s.total_j:9.1f} J/rep "
          f"({(s.total_j-truth)/truth:+.1%})")
    print(f"uncertainty (indep)  : {s.sigma_independent_j:7.1f} J  (1/√N)")
    print(f"uncertainty (worst)  : {s.sigma_worstcase_j:7.1f} J  "
          "(correlated resistor lot)")

    print("\nper-scenario breakdown (naive → good practice, mean |err|):")
    by_naive = res.by_scenario()
    by_gp = res.by_scenario(res.gp_err)
    by_energy = fleet.by_label()
    scenarios = {}
    for label in sorted(by_naive):
        n = by_naive[label]["n_devices"]
        print(f"  {label:10s} n={n:5d}  "
              f"{by_naive[label]['mean_abs_err']:6.2%} → "
              f"{by_gp[label]['mean_abs_err']:6.2%}   "
              f"({by_energy[label].total_j:8.1f} J)")
        scenarios[label] = {"n_devices": n,
                            "naive_mean_abs_err":
                                by_naive[label]["mean_abs_err"],
                            "gp_mean_abs_err": by_gp[label]["mean_abs_err"],
                            "total_j": by_energy[label].total_j}

    proj = datacenter_projection()
    print(f"\n10k-GPU projection of NVIDIA's spec gap: "
          f"${proj['annual_err_usd']:,.0f}/yr unaccounted")
    return {"n_devices": s.n_devices, "wall_s": wall, "truth_j": truth,
            "naive_j": naive_total, "good_practice_j": s.total_j,
            "naive_err": (naive_total - truth) / truth,
            "good_practice_err": (s.total_j - truth) / truth,
            "sigma_independent_j": s.sigma_independent_j,
            "sigma_worstcase_j": s.sigma_worstcase_j,
            "scenarios": scenarios,
            "annual_err_usd": proj["annual_err_usd"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-chips", type=int, default=4096)
    args = ap.parse_args(argv)
    return run(args.n_chips, resolve_device(args.device))


if __name__ == "__main__":
    main()
