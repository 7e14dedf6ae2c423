"""Wrapper of the CUDA ``fma_chain`` kernel (``csrc/fma_chain.cu``).

Replaces the TPU kernel ``_fma_chain_kernel`` (``fma_chain``,
``src/repro/kernels/fma_chain.py:26,40,55``): the paper's benchmark load
(Listing 1), a dependent chain of FMA pairs on the rows of the active
grid slots.  One CUDA block per slot and one block per SM, so
``active_fraction`` sets how many SMs burn; each thread runs 32
independent chains in registers.  Bound on an H100: operations,
``4 · niter · 128 · block_rows · n_active`` FP32 FLOPs.  The source's
header says what the design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.engine_backend import torch_backend as _tb
from repro_torch.kernels import _launch

_INT_MAX = 2 ** 31 - 1


def fma_chain(x: torch.Tensor, niter: int, active_fraction: float = 1.0,
              block_rows: int = 256) -> torch.Tensor:
    """:func:`repro_torch.engine_backend.torch_backend.fma_chain` on CPU
    tensors; the CUDA kernel on CUDA tensors."""
    if x.device.type == "cpu":
        return _tb.fma_chain(x, niter, active_fraction, block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"fma_chain runs on cpu or cuda tensors, got "
                         f"{x.device}")
    grid, n_active = _tb.fma_chain_slots(x.shape, active_fraction,
                                         block_rows)
    if niter > _INT_MAX:
        raise ValueError(f"fma_chain: niter {niter} does not fit the "
                         f"kernel's int counter")
    (xc,) = _launch.check("fma_chain", x.device,
                          [("x", x, torch.float32, (grid * block_rows, 128))])
    out = torch.empty_like(xc)
    if grid == 0:
        return out
    _launch.launch("fma_chain", x.device, [xc, out], ctypes.c_int64(grid),
                   ctypes.c_int64(block_rows),
                   ctypes.c_int64(min(n_active, grid)),
                   ctypes.c_int(max(int(niter), 0)))
    fma_chain.launches += 1
    return out


fma_chain.launches = 0
