"""Profile the port's main paths on an NVIDIA GPU: where the time goes.

    python3 chip_profile.py            # the live monitor's ingest
    python3 chip_profile.py --audit    # the batched fleet audit
    python3 chip_profile.py --serve    # recurrentgemma-9b prefill, decode

The monitor: builds the same 100,000-device fleet as ``chip_smoke.py``,
warms both monitors up, then traces the ingest of two grid slabs
(``replay``'s path) and of one permuted flattened slab with
``torch.profiler``; the slabs are built before tracing starts, so the
sensor source and the permutation stay out of the trace.

The audit: warms up with a 96-device audit, then traces
``chip_smoke.py``'s 100,000-device ``fleet_audit`` (naive and §5, every
transient kind, 25,000-device slabs).

The serving path: recurrentgemma-9b at full width and depth in bf16
(``chip_smoke.py``'s phase 8b), warmed up with a short prefill, then
traces the prefill of 2 prompts of 3000 tokens and, apart, 4 greedy
decode steps.

Prints, per trace, the wall time, the device-busy share (summed kernel
time over wall time) and the operations with the most device time.
Writes the Chrome traces to ``chiprun_out/``.
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
    # device-side entries only: an operator's own row repeats the time
    # of the kernels it launched
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
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


def audit(dev) -> None:
    from repro_torch.core.fleet_engine import fleet_audit
    names = cs.audit_fleet()

    def run(n, chunk):
        fleet_audit(n, names[:n], seed=cs.SEED, good_practice=True,
                    n_trials=cs.AUDIT_TRIALS, chunk_devices=chunk,
                    device=dev)

    run(96, 40)                                          # warm-up
    traced("audit_100k", lambda: run(cs.AUDIT_DEVICES, cs.AUDIT_CHUNK),
           host_table=True)


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--audit", action="store_true",
                    help="trace the fleet audit instead of the monitor")
    ap.add_argument("--serve", action="store_true",
                    help="trace recurrentgemma-9b's prefill and decode")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.stream import replay
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    if args.audit:
        audit(dev)
        return 0
    if args.serve:
        serve(dev)
        return 0
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
