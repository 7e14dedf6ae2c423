"""Wrapper of the CUDA ``stream_ingest_grid`` kernel
(``csrc/stream_ingest_grid.cu``).

Replaces the TPU kernel ``_ingest_grid_kernel``
(``src/repro/core/engine_backend/pallas_backend.py:276,353,390``).
Persistent blocks of 4 warps; a warp owns a device row at a time and walks
it in 128-column tiles that an asynchronous-copy ring (TMA bulk copies, or
8-byte ``cp.async`` where a span is not 16-byte aligned) brings into
shared memory ahead of use.  Each lane folds 4 consecutive columns
serially, one warp scan a tile joins the lanes, and the per-sample outputs
leave through shared memory by TMA bulk stores (the warp's own stores
where a row is not aligned).  Bound on an H100: bytes, 33 a sample (v in;
cum_e, cum_ec, run_dur, run_rec out).  The source's header says what the
design does about it.  Every shape goes to the kernel: any D, any M
(``M = 0`` passes the state through), either alignment of a row.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.engine_backend import torch_backend as _tb
from repro_torch.kernels import _build, _launch

F64, I64, BOOL = torch.float64, torch.int64, torch.bool


def stream_ingest_grid(ts, v, prev_t, prev_v, has_prev, run_t, n_changes,
                       gain, offset, tshift, win_a, win_b, max_hold, env_lo,
                       env_hi, trapezoid: bool = False):
    """:func:`repro_torch.engine_backend.torch_backend.stream_ingest_grid`
    on CPU tensors; the CUDA kernel on CUDA tensors."""
    if v.device.type == "cpu":
        return _tb.stream_ingest_grid(ts, v, prev_t, prev_v, has_prev, run_t,
                                      n_changes, gain, offset, tshift, win_a,
                                      win_b, max_hold, env_lo, env_hi,
                                      trapezoid)
    if v.device.type != "cuda":
        raise ValueError(f"stream_ingest_grid runs on cpu or cuda tensors, "
                         f"got {v.device}")
    d, m = v.shape
    ins = _launch.check("stream_ingest_grid", v.device, [
        ("ts", ts, F64, (m,)), ("v", v, F64, (d, m)),
        ("prev_t", prev_t, F64, (d,)), ("prev_v", prev_v, F64, (d,)),
        ("has_prev", has_prev, BOOL, (d,)), ("run_t", run_t, F64, (d,)),
        ("n_changes", n_changes, I64, (d,)), ("gain", gain, F64, (d,)),
        ("offset", offset, F64, (d,)), ("tshift", tshift, F64, (d,)),
        ("win_a", win_a, F64, (d,)), ("win_b", win_b, F64, (d,)),
        ("max_hold", max_hold, F64, (d,)), ("env_lo", env_lo, F64, (d,)),
        ("env_hi", env_hi, F64, (d,))])
    out = _tb.IngestGridOut.empty(d, (d, m), v.device)
    _launch.launch("stream_ingest_grid", v.device, ins + list(out),
                   ctypes.c_int64(d), ctypes.c_int64(m),
                   ctypes.c_int(int(bool(trapezoid))))
    stream_ingest_grid.launches += 1
    return out


stream_ingest_grid.launches = 0

CONFIG_FIELDS = ("blocks_per_sm", "sms", "grid_blocks", "threads",
                 "smem_bytes", "registers", "local_bytes")


def launch_config(d: int, device, trapezoid: bool = False) -> dict:
    """How the kernel launches for ``d`` rows on CUDA ``device``: its
    resident blocks an SM (from the occupancy calculator), the SM count,
    the grid's blocks, threads a block, dynamic shared memory a block, and
    the loaded kernel's registers and local memory (spills) a thread
    (:data:`CONFIG_FIELDS`)."""
    fn = _build.load("stream_ingest_grid").stream_ingest_grid_config
    fn.argtypes = [ctypes.c_int64, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * len(CONFIG_FIELDS))()
    with torch.cuda.device(device):
        rc = fn(d, int(bool(trapezoid)), out)
    if rc != 0:
        raise RuntimeError(f"stream_ingest_grid: launch configuration "
                           f"failed (CUDA error {rc})")
    return dict(zip(CONFIG_FIELDS, out))
