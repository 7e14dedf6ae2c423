"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The program under test is the checkout's
``src/repro_torch``.  Set-up (``setup_s``) is timed from the start of this
process.  The run exits non-zero, printing no result, without a card, with
fewer cards than the cell asks for, or when JAX or the JAX package was
loaded into this process.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: host threads for torch's CPU ops: load from one process with few threads
HOST_THREADS = 4


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import repro_torch  # noqa: F401  the program under test
    from portbench import harness

    torch.set_num_threads(HOST_THREADS)
    cell = harness.find_cell(harness.benchmark(ROOT), args.workload,
                             seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device="cuda")
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = harness.driver(cell.config["system"]).run(cell, T0)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = harness.result_line(cell, out)
    for text in harness.check_lines(out.checks):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
