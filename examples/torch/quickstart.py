"""Quickstart on the card: characterise a power sensor black-box, then
measure a workload's energy the naive way and the paper's good-practice
way (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
        [--store DIR]

The calibration is stored under ``--store`` (default
``build/examples/calib`` in the checkout); a second run reads it back.
"""
import argparse
import os

from repro_torch._device import resolve_device
from repro_torch.core import (CalibrationStore, GoodPracticeConfig,
                              GroundTruthMeter, OnboardSensor, Workload,
                              measure_good_practice, measure_naive)
from repro_torch.core import load as loads
from repro_torch.core import profiles

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STORE = os.path.join(ROOT, "build", "examples", "calib")


def run(store_dir=STORE, device="cuda"):
    """Characterise, measure and print; returns the printed numbers."""
    dev = resolve_device(device)
    # 1. An A100-class sensor: 100 ms update period, but only a 25 ms
    #    averaging window — 75 % of the runtime is never observed.
    profile = profiles.get("a100")
    sensor = OnboardSensor(profile, seed=42, device=dev)
    pmd = GroundTruthMeter(seed=7, device=dev)      # external power meter

    # 2. Characterise it black-box (the paper's micro-benchmarks).
    store = CalibrationStore(store_dir)
    calib = store.get_or_characterise("gpu0", sensor, pmd)
    print(f"update period : {calib.update_period_s*1e3:6.1f} ms")
    print(f"boxcar window : {calib.window_s*1e3:6.1f} ms")
    print(f"sampled frac  : {calib.sampled_fraction:6.2f}")
    print(f"gain / offset : {calib.gain:.4f} / {calib.offset_w:+.2f} W")

    # 3. A bursty workload: 60 ms hot phase + 40 ms cool phase.
    wl = Workload("bursty", loads.multi_phase_workload(
        [(0.060, 230.0), (0.040, 140.0)]))
    truth = wl.true_energy_j

    # 4. Naive single-shot vs good practice.
    sensor2 = OnboardSensor(profile, seed=43, device=dev)
    naive = measure_naive(sensor2, wl)
    est = measure_good_practice(sensor2, wl, calib,
                                GoodPracticeConfig(apply_calibration=True))
    print(f"\ntruth          : {truth:8.2f} J/rep")
    print(f"naive          : {naive:8.2f} J/rep ({(naive-truth)/truth:+.1%})")
    print(f"good practice  : {est.joules_per_rep:8.2f} J/rep "
          f"({est.error_vs(truth):+.1%})  ± {est.std_j:.2f} J")
    return {"update_period_s": calib.update_period_s,
            "window_s": calib.window_s,
            "sampled_fraction": calib.sampled_fraction,
            "gain": calib.gain, "offset_w": calib.offset_w,
            "truth_j": truth, "naive_j": naive,
            "good_practice_j": est.joules_per_rep, "std_j": est.std_j,
            "naive_err": (naive - truth) / truth,
            "good_practice_err": est.error_vs(truth)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--store", default=STORE,
                    help="calibration store directory")
    args = ap.parse_args(argv)
    return run(args.store, resolve_device(args.device))


if __name__ == "__main__":
    main()
