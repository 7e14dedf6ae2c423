"""Profile the port's serving path on an NVIDIA GPU: where the time goes.

    python3 chip_profile.py

recurrentgemma-9b at full width and depth in bf16 (``chip_smoke.py``'s
phase 8b), warmed up with a short prefill, then traces the prefill of 2
prompts of 3000 tokens and, apart, 4 greedy decode steps.  The monitor's
ingest and the fleet audit are traced by the benchmark instead, with the
program's own spans: ``python3 -m portbench.run --workload <cell> --seed
<n> --seconds <s> --trace 1``.

Prints, per trace, the wall time, the device-busy share (the union of the
device's operations over the wall time, so operations that overlap count
once) and the operations with the most device time.  Writes the Chrome
traces to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")


def busy_us(intervals) -> float:
    """Microseconds covered by the union of ``intervals``."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def traced(label, fn, host_table=False):
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
    dev_us = busy_us([(e.time_range.start, e.time_range.end)
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA])
    print(f"== {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{dev_us / 1e3:.1f} ms ({dev_us / 1e6 / wall:.1%}), idle share "
          f"{1 - dev_us / 1e6 / wall:.1%}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=22,
                       max_name_column_width=60), flush=True)
    if host_table:
        print(events.table(sort_by="self_cpu_time_total", row_limit=22,
                           max_name_column_width=60), flush=True)
    for e in events:
        if e.device_type == DeviceType.CUDA and any(
                k in e.key for k in ("stream_ingest", "log_filter",
                                     "rglru_scan", "flash_attention")):
            print(f"{e.key}: {e.count} launches, "
                  f"{e.self_device_time_total / 1e3:.3f} ms on the device",
                  flush=True)
    os.makedirs(OUT, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT, f"trace_{label}.json"))


def serve(dev) -> None:
    from repro_torch.configs.registry import get_config
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    cfg = get_config(cs.LM_ARCH)
    params = api.init_params(cs.SEED + 37, cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 41)
    toks = torch.randint(0, cfg.vocab, (cs.LM_BATCH, cs.LM_PROMPT),
                         generator=gen, device=dev, dtype=torch.int32)
    _, c = tf.prefill(params, cfg, {"tokens": toks[:, :64]},
                      max_seq=cs.LM_MAX_SEQ)                # warm-up
    api.decode_step(params, cfg, c, {"tokens": toks[:, 64:65], "pos": 64})
    del c
    state = {}

    def prefill():
        logits, state["cache"] = tf.prefill(params, cfg, {"tokens": toks},
                                            max_seq=cs.LM_MAX_SEQ)
        state["next"] = logits[:, -1].argmax(-1)

    traced("serve_prefill_2x3000", prefill)

    def decode(n=4):
        for i in range(n):
            lg, state["cache"] = api.decode_step(
                params, cfg, state["cache"],
                {"tokens": state["next"][:, None].to(torch.int32),
                 "pos": cs.LM_PROMPT + i})
            state["next"] = lg[:, 0].argmax(-1)

    decode(1)                                               # warm-up
    traced("serve_decode_4_steps", decode, host_table=True)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    serve(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
