"""Time the parts of a port's ``log_filter`` and ``step_integrate`` calls
on an NVIDIA GPU.

    python3 tools/kernel_split.py [--tree DIR]

``DIR`` (default: this checkout) is the root of a checkout whose
``src/repro_torch`` is measured, so one call can time an older tree (a
``git archive`` unpacked under ``build/``) beside this one.  Inputs are
made from a seed at the port's main-path shapes:

* ``log_filter`` at the audit's [4183, 649] ticks against one shared row
  of 64 segments: the wrapper; where the tree's kernel takes a span, the
  wrapper's ``log_filter_span`` alone and each of its two launches alone
  (the tree's own source with two entry points appended, built here);
* ``step_integrate`` at a §5 trial's [1, 7440], a window of ~4,900
  samples: the wrapper, and the kernel alone on a preallocated output;
* an empty kernel of the same grid (1 block of 256 threads), the floor
  of a launch.

Every launch goes through the tree's own ``_launch.launch``.  Times are
CUDA events around repeated calls enqueued behind a device-side sleep
(as ``chip_smoke.py``'s ``time_ms``).  Prints the card's name and power
limit, one line per figure and a JSON object last.  Exits 1 without a
card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: appended to the tree's log_filter.cu: its two launches, one at a time
PIECES = r"""
extern "C" int split_states_launch(void* const* ptrs, int64_t r, int64_t g,
                                   int64_t s, void* stream) {
  repro_torch::LogFilterArgs a;
  memcpy(&a, ptrs, sizeof(a));
  const int64_t t = repro_torch::kThreads;
  repro_torch::log_filter_states_kernel<<<(unsigned)((g + t - 1) / t),
      repro_torch::kThreads, 0, (cudaStream_t)stream>>>(a, r, g, s);
  return (int)cudaGetLastError();
}
extern "C" int split_readings_launch(void* const* ptrs, int64_t r, int64_t g,
                                     int64_t s, int64_t m, void* stream) {
  repro_torch::LogFilterArgs a;
  memcpy(&a, ptrs, sizeof(a));
  const int64_t t = repro_torch::kThreads;
  repro_torch::log_filter_readings_kernel<<<(unsigned)((g * m + t - 1) / t),
      repro_torch::kThreads, 0, (cudaStream_t)stream>>>(a, r, g, s, m);
  return (int)cudaGetLastError();
}
"""

#: an empty kernel with step_integrate's launch arguments and grid
EMPTY = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void split_empty_kernel() {}
extern "C" int split_null_launch(void* const* ptrs, int64_t n, int64_t m,
                                 int trapezoid, void* stream) {
  split_empty_kernel<<<(unsigned)n, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""

#: each piece's library exports <name>_error_string and <name>_num_pointers
EXPORTS = r"""
extern "C" const char* %(name)s_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
extern "C" int %(name)s_num_pointers() { return %(n)d; }
"""


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_piece(build, flags, nvcc, name, source, exports):
    """Compile ``source`` (plus the error-string and pointer-count
    exports of each ``(name, pointers)``) into ``build/<name>.so``."""
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source + "".join(EXPORTS % dict(name=n, n=k)
                                 for n, k in exports))
    out = os.path.join(build, f"{name}.so")
    subprocess.run([nvcc, *flags, "-o", out, src], check=True,
                   capture_output=True, text=True, timeout=600)
    return ctypes.CDLL(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    tree = os.path.abspath(ap.parse_args().tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.engine_backend import torch_backend as tb
    from repro_torch.engine_backend.pytrees import TimelineArrays
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels import log_filter as k_log
    from repro_torch.kernels import step_integrate as k_step

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"tree {tree}", flush=True)
    f64 = dict(dtype=torch.float64, device=dev)
    rng = np.random.default_rng(0)
    res = {"tree": tree, "card": smi}

    # log_filter at [4183, 649], one shared row of 64 segments
    g, m, s = 4183, 649, 64
    edges = 0.4 + np.concatenate([[0.0], np.cumsum(rng.uniform(0.01, 0.05,
                                                               s))])
    tl = TimelineArrays(torch.as_tensor(edges[None], **f64),
                        torch.as_tensor(rng.uniform(60, 300, (1, s)), **f64),
                        torch.full((1,), 60.0, **f64),
                        torch.full((1,), s, dtype=torch.int64, device=dev))
    period = 1.05 * (edges[-1] + 0.3) / m
    ticks = torch.as_tensor(rng.uniform(-0.2, 0.0, (g, 1))
                            + period * np.arange(m)[None, :], **f64)
    tau = torch.as_tensor(np.where(rng.random(g) < 0.5, 0.8, 0.6), **f64)
    res["log_filter_wrapper_ms"] = time_ms(
        torch, lambda: k_log.log_filter(tl, ticks, tau), 20)
    src = (_build.CSRC / _build.SOURCES["log_filter"]).read_text()
    build = os.path.join(ROOT, "build", "kernel_split")
    nvcc = _build.nvcc_path()
    if "const double* span;" in src:
        res["log_filter_span_ms"] = time_ms(
            torch, lambda: tb.log_filter_span(tl, ticks, tau), 20)
        lib = build_piece(build, _build.NVCC_FLAGS, nvcc, "pieces",
                          src + PIECES, [("split_states", 8),
                                         ("split_readings", 8)])
        _build._loaded["split_states"] = lib
        _build._loaded["split_readings"] = lib
        span = tb.log_filter_span(tl, ticks, tau)
        states = torch.empty((s + 3, g), **f64)
        out = torch.empty((g, m), **f64)
        ptrs = list(tl[:3]) + [ticks, tau, span, states, out]
        i64 = ctypes.c_int64
        res["log_filter_states_ms"] = time_ms(torch, lambda: _launch.launch(
            "split_states", dev, ptrs, i64(1), i64(g), i64(s)), 20)
        res["log_filter_readings_ms"] = time_ms(torch, lambda: _launch.launch(
            "split_readings", dev, ptrs, i64(1), i64(g), i64(s), i64(m)), 20)
        torch.cuda.synchronize()
        want = tb.log_filter(tl, ticks, tau)
        res["log_filter_pieces_max_abs_err"] = float((out - want).abs().max())

    # step_integrate at a §5 trial's [1, 7440]
    n, m = 1, 7440
    ts = torch.as_tensor(np.cumsum(rng.uniform(0.5e-3, 1.5e-3, (n, m)), 1),
                         **f64)
    vals = torch.as_tensor(rng.uniform(60.0, 250.0, (n, m)), **f64)
    t0 = ts[:, 1200] + 1e-4
    t1 = ts[:, 6100] + 1e-4
    res["step_wrapper_ms"] = time_ms(
        torch, lambda: k_step.step_integrate(ts, vals, t0, t1), 200)
    out = torch.empty(n, **f64)
    args = [ts, vals, t0, t1, out]
    scal = (ctypes.c_int64(n), ctypes.c_int64(m), ctypes.c_int(0))
    res["step_kernel_ms"] = time_ms(torch, lambda: _launch.launch(
        "step_integrate", dev, args, *scal), 200)
    _build._loaded["split_null"] = build_piece(
        build, _build.NVCC_FLAGS, nvcc, "empty", EMPTY, [("split_null", 5)])
    res["null_launch_ms"] = time_ms(torch, lambda: _launch.launch(
        "split_null", dev, args, *scal), 200)
    torch.cuda.synchronize()
    want = tb.step_integrate(ts, vals, t0, t1)
    res["step_kernel_abs_err"] = float((out - want).abs().max())
    for k, v in res.items():
        print(f"{k}: {v}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
