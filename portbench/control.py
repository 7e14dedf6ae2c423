"""The output check's control: the plain reference put in the program's
place one precision step lower (float32 for the configurations' float64),
judged by the same comparison against the float64 reference.  It has to
come out not correct; its readings set the upper end of each limit.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \
        [--slabs N] [--audits K]

runs at the cell's own size on the card (``--device cpu`` and a smaller
configuration for the tests) and prints one JSON line a seed with every
number compared.  ``--slabs`` is the number of monitor slabs a run's
window ingests; ``--audits`` the number of audits it checks.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness


def monitor_control(cell, seed: int, n_slabs: int) -> dict:
    from portbench.drivers.monitor import BETWEEN_S
    from portbench.gen.monitor import MonitorTraffic
    from portbench.reference import compare
    from portbench.reference import monitor as reference
    gen = MonitorTraffic(cell.config, cell.traffic, seed, cell.device)
    gen.flat = None
    t_last = gen.last_time(n_slabs - 1)
    tb = (t_last - BETWEEN_S[0], t_last - BETWEEN_S[1])
    want = reference.expected(gen, n_slabs, tb, torch.float64)
    low = reference.expected(gen, n_slabs, tb, torch.float32)
    return compare.monitor(low, want)


def audit_control(cell, seed: int, n_audits: int) -> dict:
    from portbench.drivers.audit import KEYS, sample_rows
    from portbench.reference import compare
    from portbench.reference.audit import AuditReference
    n = int(cell.config["n_devices"])
    size = int(cell.traffic["sample_per_audit"])
    want = AuditReference(cell.config, torch.float64, cell.device)
    low = AuditReference(cell.config, torch.float32, cell.device)
    gaps = {"energy_gap": [], "error_gap": []}
    for k in range(n_audits):
        s = seed + int(cell.traffic["seed_step"]) * (k + 1)
        rows = sample_rows(seed, k, n, size)
        a, b = want.audit(s, rows), low.audit(s, rows)
        for key in KEYS:
            name = "error_gap" if key.endswith("_err") else "energy_gap"
            gaps[name].append(compare.rel_gap(b[key], a[key]))
    return {name: compare.worst(v) for name, v in gaps.items()}


def control(cell, seed: int, n_slabs: int = 0, n_audits: int = 1) -> dict:
    if cell.config["system"] == "monitor":
        return monitor_control(cell, seed, n_slabs)
    return audit_control(cell, seed, n_audits)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--slabs", type=int, default=0)
    ap.add_argument("--audits", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(harness.ROOT / "src"))
    cell = harness.find_cell(harness.benchmark(), args.workload, seed=0,
                             seconds=0, trace=False, device=args.device)
    limits = harness.limits(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        vals = control(cell, seed, args.slabs, args.audits)
        fails = sorted(k for k, v in vals.items()
                       if not v <= float(limits[k]))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": vals, "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
