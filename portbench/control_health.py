"""The hardened monitor cell's control: its plain reference one precision
step lower (float32) in the program's place, judged by the cell's own
comparison against the float64 reference.  It has to come out not
correct; its readings set the upper end of each limit.

    python3 -m portbench.control_health --workload <name> --seeds 1,2,3 \
        --slabs N

runs at the cell's own size on the card (``--device cpu`` and a smaller
configuration for the tests) and prints one JSON line a seed with every
number compared.  ``--slabs`` is the number of slabs a run ingests,
warm-up included.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness


def control(cell, seed: int, n_slabs: int) -> dict:
    from portbench.drivers.monitor_health import checks
    from portbench.gen.monitor_health import FaultyTraffic
    from portbench.reference import monitor_health as reference
    gen = FaultyTraffic(cell.config, cell.traffic, seed, cell.device)
    gen.free()
    want = reference.expected(gen, n_slabs, torch.float64)
    low = reference.expected(gen, n_slabs, torch.float32)
    return checks(low, want, int(cell.config["ring_slots"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control_health")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--slabs", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(harness.ROOT / "src"))
    cell = harness.find_cell(harness.benchmark(), args.workload, seed=0,
                             seconds=0, trace=False, device=args.device)
    limits = harness.limits(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        vals = control(cell, seed, args.slabs)
        fails = sorted(k for k, v in vals.items()
                       if not v <= float(limits[k]))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": vals, "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
