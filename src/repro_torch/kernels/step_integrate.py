"""Wrapper of the CUDA ``step_integrate`` kernel
(``csrc/step_integrate.cu``).

Replaces the TPU kernel ``_step_kernel`` (``_step_integrate_impl`` /
``step_integrate``, ``src/repro/core/engine_backend/pallas_backend.py:
424,456,467,481``): the per-row integral of a held sample series over a
window, the §5 protocol's integrator.  One block per row finds the
window's edges in two rounds of loads by the whole block (a pivot a
thread, then the two brackets) and reduces ``dens·dt`` over them in a
fixed tree order.  Bound on an H100: memory, ``N·M·16 + N·24`` bytes
with every input read whole (the samples and readings in, the window in,
the integral out), 16 bytes per selected sample plus 24 per row for what
the windows need.  The source's header says what the design does about
it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.engine_backend import torch_backend as _tb
from repro_torch.kernels import _launch

F64 = torch.float64


def step_integrate(ts: torch.Tensor, vals: torch.Tensor, t0: torch.Tensor,
                   t1: torch.Tensor, trapezoid: bool = False) -> torch.Tensor:
    """:func:`repro_torch.engine_backend.torch_backend.step_integrate` on
    CPU tensors; the CUDA kernel on CUDA tensors."""
    if ts.device.type == "cpu":
        return _tb.step_integrate(ts, vals, t0, t1, trapezoid)
    if ts.device.type != "cuda":
        raise ValueError(f"step_integrate runs on cpu or cuda tensors, got "
                         f"{ts.device}")
    n, m = ts.shape
    ins = _launch.check("step_integrate", ts.device, [
        ("ts", ts, F64, (n, m)), ("vals", vals, F64, (n, m)),
        ("t0", t0, F64, (n,)), ("t1", t1, F64, (n,))])
    if n == 0 or m == 0:        # no samples: every window integrates to 0
        return torch.zeros(n, dtype=F64, device=ts.device)
    out = torch.empty(n, dtype=F64, device=ts.device)   # every row written
    _launch.launch("step_integrate", ts.device, ins + [out],
                   ctypes.c_int64(n), ctypes.c_int64(m),
                   ctypes.c_int(int(bool(trapezoid))))
    step_integrate.launches += 1
    return out


step_integrate.launches = 0


def empty_launch(ts: torch.Tensor, trapezoid: bool = False) -> None:
    """Launch an empty kernel with the grid and block that
    :func:`step_integrate` launches for CUDA ``ts`` [N, M], through the
    same path: the floor under its time.  Counts nothing."""
    n, m = ts.shape
    _launch.launch("step_integrate", ts.device, [None] * 5,
                   ctypes.c_int64(n), ctypes.c_int64(m),
                   ctypes.c_int(int(bool(trapezoid))),
                   entry="step_integrate_empty_launch")
