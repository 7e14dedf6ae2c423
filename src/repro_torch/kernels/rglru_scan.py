"""The RG-LRU linear recurrence: the CUDA ``rglru_scan`` kernel
(``csrc/rglru_scan.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``_rglru_kernel`` (``rglru_scan``,
``src/repro/kernels/rglru_scan.py:22,40``): h_t = a_t ⊙ h_{t−1} + u_t
over a, u [B, S, D], an f32 carry, time in order, each step one fused
multiply-add, the output in u's type.  One CUDA thread per (batch,
channel) walks time with the carry in a register, loading the next steps
while it runs the current ones.
Bound on an H100: bytes, 3 · B · S · D · 4 (the source's header says what
the design does about it).  The model reaches it through
:func:`repro_torch.models.recurrent.rglru_scan_ref`, where the reference
runs its jnp associative scan.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """a · b + c on float32 tensors rounded once, as a fused multiply-add
    does: the product is exact in float64, the float64 sum is rounded to
    odd (its exact error from Knuth's TwoSum decides the last bit), and
    rounding that to float32 is then the correctly rounded result."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(fix, torch.nextafter(s, away), s)
    return s.float()


def rglru_scan_plain(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h_t = fma(a_t, h_{t−1}, u_t) with h_{−1} = 0, in f32, time in
    order; returned in u's type.  The Pallas kernel's contract (its
    identity padding of the time axis changes nothing), each step rounded
    once as XLA's CPU backend runs the Pallas kernel in interpret mode
    and as the CUDA kernel's ``__fmaf_rn`` computes it."""
    assert a.dim() == 3 and a.shape == u.shape, (a.shape, u.shape)
    af, uf = a.float(), u.float()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    for t in range(a.shape[1]):
        h = fma_f32(af[:, t], h, uf[:, t])
        out[:, t] = h
    return out.to(u.dtype)


def rglru_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`rglru_scan_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors (a and u cast to f32 first, the result in u's type)."""
    if a.device.type == "cpu" and u.device.type == "cpu":
        return rglru_scan_plain(a, u)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda tensors, got "
                         f"{a.device}")
    if a.dim() != 3 or a.shape != u.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and u "
                         f"{tuple(u.shape)} must be the same [B, S, D]")
    shape = tuple(a.shape)
    af, uf = _launch.check("rglru_scan", a.device, [
        ("a", a.float(), torch.float32, shape),
        ("u", u.float(), torch.float32, shape)])
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out.to(u.dtype)
    B, S, D = shape
    _launch.launch("rglru_scan", a.device, [af, uf, out], ctypes.c_int64(B),
                   ctypes.c_int64(S), ctypes.c_int64(D))
    rglru_scan.launches += 1
    return out.to(u.dtype)


rglru_scan.launches = 0
