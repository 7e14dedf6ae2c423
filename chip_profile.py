"""Profile the port's main path on an NVIDIA GPU: where a slab's time goes.

    python3 chip_profile.py

Builds the same 100,000-device fleet as ``chip_smoke.py``, warms both
monitors up, then traces the ingest of two grid slabs (``replay``'s
path) and of one permuted flattened slab with ``torch.profiler``; the
slabs are built before tracing starts, so the sensor source and the
permutation stay out of the trace.  Prints, per path, the wall time, the
device-busy share (summed kernel time over wall time) and the operations
with the most device time.  Writes the Chrome traces to
``chiprun_out/``.
"""
from __future__ import annotations

import os
import sys
import time

import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")


def traced(label, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side entries only: an operator's own row repeats the time
    # of the kernels it launched
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    print(f"== {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.1f} ms ({dev_us / 1e6 / wall:.1%}), idle share "
          f"{1 - dev_us / 1e6 / wall:.1%}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=22,
                       max_name_column_width=60), flush=True)
    os.makedirs(OUT, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT, f"trace_{label}.json"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.stream import replay
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    names, _, shifts, bank = cs.fleet(dev, cs.N_DEVICES)

    grid = cs.monitor(dev, names, shifts)
    replay(bank, grid, 0.0, 1.0, cs.PERIOD_S, cs.TICK_S,
           chunk_devices=cs.N_DEVICES)                   # warm-up: 2 slabs

    slabs = list(bank.iter_poll_slabs(1.0, 2.0, cs.PERIOD_S, cs.TICK_S,
                                      chunk_devices=cs.N_DEVICES,
                                      grid=True))

    def grid_slabs():
        for d, t, v in slabs:
            grid.ingest_grid(d, t, v)

    traced("grid_2_slabs", grid_slabs)
    del grid, slabs

    flat = cs.monitor(dev, names, shifts)
    first, second = cs.flat_slabs(bank, 1.0, dev)
    flat.ingest(*first)                                  # warm-up: 1 slab

    traced("flat_1_slab", lambda: flat.ingest(*second))
    return 0


if __name__ == "__main__":
    sys.exit(main())
