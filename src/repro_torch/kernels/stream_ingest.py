"""Wrapper of the CUDA ``stream_ingest`` kernel (``csrc/stream_ingest.cu``).

Replaces the TPU kernel ``_ingest1d_kernel`` and its jax epilogue
(``src/repro/core/engine_backend/pallas_backend.py:99,154,238``).  One
thread block per device group walks the group's samples in chunks with a
block-wide scan and writes the group's outputs itself, the reading
moments of the per-label statistics included.  Bound on an H100: memory,
about 49 bytes per sample (t, v in; cum_e, cum_ec, vc, run_dur, run_rec
out).  The source's header says what the design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.engine_backend import torch_backend as _tb
from repro_torch.kernels import _launch

F64, I64, BOOL = torch.float64, torch.int64, torch.bool


def stream_ingest(t, v, seg, first, start_idx, end_idx, prev_t, prev_v,
                  has_prev, run_t, n_changes, gain, offset, tshift, win_a,
                  win_b, max_hold, env_lo, env_hi, trapezoid: bool = False):
    """:func:`repro_torch.engine_backend.torch_backend.stream_ingest` on
    CPU tensors; the CUDA kernel on CUDA tensors (``seg``/``first`` are
    implied by ``start_idx``/``end_idx`` and not read there)."""
    if t.device.type == "cpu":
        return _tb.stream_ingest(t, v, seg, first, start_idx, end_idx,
                                 prev_t, prev_v, has_prev, run_t, n_changes,
                                 gain, offset, tshift, win_a, win_b,
                                 max_hold, env_lo, env_hi, trapezoid)
    if t.device.type != "cuda":
        raise ValueError(f"stream_ingest runs on cpu or cuda tensors, "
                         f"got {t.device}")
    k, u = t.shape[0], prev_t.shape[0]
    ins = _launch.check("stream_ingest", t.device, [
        ("t", t, F64, (k,)), ("v", v, F64, (k,)),
        ("start_idx", start_idx, I64, (u,)), ("end_idx", end_idx, I64, (u,)),
        ("prev_t", prev_t, F64, (u,)), ("prev_v", prev_v, F64, (u,)),
        ("has_prev", has_prev, BOOL, (u,)), ("run_t", run_t, F64, (u,)),
        ("n_changes", n_changes, I64, (u,)), ("gain", gain, F64, (u,)),
        ("offset", offset, F64, (u,)), ("tshift", tshift, F64, (u,)),
        ("win_a", win_a, F64, (u,)), ("win_b", win_b, F64, (u,)),
        ("max_hold", max_hold, F64, (u,)), ("env_lo", env_lo, F64, (u,)),
        ("env_hi", env_hi, F64, (u,))])
    out = _tb.IngestOut.empty(u, (k,), t.device)
    _launch.launch("stream_ingest", t.device, ins + list(out),
                   ctypes.c_int64(u), ctypes.c_int(int(bool(trapezoid))))
    stream_ingest.launches += 1
    return out


stream_ingest.launches = 0
