"""Wrapper of the CUDA ``log_filter`` kernel (``csrc/log_filter.cu``).

Replaces the TPU kernel ``_scan_kernel``
(``src/repro/core/engine_backend/pallas_backend.py:497,516,566``): the
Kepler/Maxwell first-order sensor filter.  One thread per device row walks
the row's segments in order and stores each segment's entry state, then
one thread per (row, tick) finds the tick's segment and decays that state
to it.  Bound on an H100: memory, 16 bytes per tick (tick in, reading
out).  The source's header says what the design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.engine_backend import torch_backend as _tb
from repro_torch.engine_backend.pytrees import TimelineArrays
from repro_torch.kernels import _launch

F64 = torch.float64


def log_filter(tl: TimelineArrays, ticks: torch.Tensor,
               tau: torch.Tensor) -> torch.Tensor:
    """:func:`repro_torch.engine_backend.torch_backend.log_filter` on CPU
    tensors; the CUDA kernel on CUDA tensors."""
    if ticks.device.type == "cpu":
        return _tb.log_filter(tl, ticks, tau)
    if ticks.device.type != "cuda":
        raise ValueError(f"log_filter runs on cpu or cuda tensors, got "
                         f"{ticks.device}")
    g, m = ticks.shape
    r, s1 = tl.edges.shape
    s = s1 - 1
    if r not in (1, g):
        raise ValueError(f"log_filter: {g} tick rows for {r} timeline rows")
    ins = _launch.check("log_filter", ticks.device, [
        ("edges", tl.edges, F64, (r, s + 1)),
        ("powers", tl.powers, F64, (r, s)),
        ("idle_w", tl.idle_w, F64, (r,)), ("ticks", ticks, F64, (g, m)),
        ("tau", tau, F64, (g,))])
    span = _tb.log_filter_span(tl, ticks, tau)
    states = torch.empty((s + 3, g), dtype=F64, device=ticks.device)
    out = torch.empty((g, m), dtype=F64, device=ticks.device)
    _launch.launch("log_filter", ticks.device, ins + [span, states, out],
                   ctypes.c_int64(r), ctypes.c_int64(g), ctypes.c_int64(s),
                   ctypes.c_int64(m))
    log_filter.launches += 1
    return out


log_filter.launches = 0
