import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
# the program under test and the benchmark, as a checkout's root has them
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: a monitor cell's configuration cut to what the CPU holds: 64 devices
SMALL_MONITOR = {"n_devices": 64}
#: an audit cell's, cut to 3,000 devices in 1,000-device slabs
SMALL_AUDIT = {"n_devices": 3000, "chunk_devices": 1000}


@pytest.fixture
def small_cell():
    """``small_cell(workload, seed=..., trace=...)``: the cell as a CPU run
    sees it, cut to a test's size, with a short window."""
    from portbench import harness

    def make(workload, seed=2**31 + 17, trace=False, seconds=0.5, root=ROOT):
        bench = harness.benchmark(root)
        w = {x["name"]: x for x in bench["workloads"]}[workload]
        sys_ = harness.read_json(root / {c["name"]: c for c in
                                         bench["configs"]}[w["config"]]
                                 ["file"])["system"]
        cell = harness.find_cell(
            bench, workload, seed=seed, seconds=seconds, trace=trace,
            device="cpu", root=root,
            overrides=SMALL_MONITOR if sys_ == "monitor" else SMALL_AUDIT)
        # job windows in the first cycles, which a short run reaches
        cell.traffic.update(trace_slabs=4, warmup_devices=1000,
                            sample_per_audit=128, job_cycles=2)
        return cell
    return make
