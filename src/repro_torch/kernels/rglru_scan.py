"""The RG-LRU linear recurrence: the CUDA ``rglru_scan`` kernel
(``csrc/rglru_scan.cu``), its backward kernel ``rglru_scan_bwd``
(``csrc/rglru_scan_bwd.cu``) and their plain PyTorch versions.

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

Gradients flow through a :class:`torch.autograd.Function` whenever grad
mode is on and a or u requires grad: its forward is the same launch,
and it saves a (f32) and the f32 output h; its backward is
:func:`rglru_scan_bwd`.  The TPU kernel had no backward (the reference
trains through ``jax.grad`` of its jnp oracle), so ``rglru_scan_bwd``
replaces no TPU kernel.  With grad off, :func:`rglru_scan` is the
forward alone: one launch a call, nothing saved.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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


def _scan_f32(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The forward's f32 output: :func:`rglru_scan_plain` on CPU tensors,
    the CUDA kernel (one launch, counted) on CUDA tensors."""
    if a.device.type == "cpu" and u.device.type == "cpu":
        return rglru_scan_plain(a.float(), u.float())
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
        return out
    B, S, D = shape
    _launch.launch("rglru_scan", a.device, [af, uf, out], ctypes.c_int64(B),
                   ctypes.c_int64(S), ctypes.c_int64(D))
    rglru_scan.launches += 1
    return out


class _RGLRUScan(torch.autograd.Function):
    """h = rglru_scan(a, u) with :func:`rglru_scan_bwd` as its backward."""

    @staticmethod
    def forward(ctx, a, u):
        h = _scan_f32(a, u)
        ctx.save_for_backward(a.float(), h)
        ctx.types = (a.dtype, u.dtype)
        return h.to(u.dtype)

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, du = rglru_scan_bwd(a, h, dh.float())
        a_type, u_type = ctx.types
        return da.to(a_type), du.to(u_type)


def rglru_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`rglru_scan_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors (a and u cast to f32 first, the result in u's type).  Under
    grad mode, with a or u requiring grad, through :class:`_RGLRUScan`,
    whose backward is :func:`rglru_scan_bwd`."""
    if torch.is_grad_enabled() and (a.requires_grad or u.requires_grad):
        return _RGLRUScan.apply(a, u)
    return _scan_f32(a, u).to(u.dtype)


rglru_scan.launches = 0


def rglru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor,
                         dh: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's backward in f32, time reversed: g_{S-1} =
    dh_{S-1}, g_t = fma(a_{t+1}, g_{t+1}, dh_t); du = g and da_t = g_t ·
    h_{t-1} with h_{-1} = 0.  a, h (the forward's f32 output) and dh are
    f32 [B, S, D]; returns (da, du), f32.  Each step is rounded as
    ``csrc/rglru_scan_bwd.cu`` rounds it (one FMA, one product), so the
    two agree bitwise."""
    assert a.shape == h.shape == dh.shape and a.dim() == 3, (
        a.shape, h.shape, dh.shape)
    a, h, dh = a.float(), h.float(), dh.float()
    S = a.shape[1]
    du = torch.empty_like(dh)
    da = torch.empty_like(dh)
    if S == 0:
        return da, du
    g = dh[:, S - 1].clone()
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            g = fma_f32(a[:, t + 1], g, dh[:, t])
        du[:, t] = g
        da[:, t] = g * h[:, t - 1] if t > 0 else torch.zeros_like(g)
    return da, du


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, du) of the recurrence, f32 [B, S, D]:
    :func:`rglru_scan_bwd_plain` on CPU tensors, the CUDA kernel
    ``rglru_scan_bwd`` (one launch, counted in ``rglru_scan_bwd.launches``)
    on CUDA tensors."""
    if all(x.device.type == "cpu" for x in (a, h, dh)):
        return rglru_scan_bwd_plain(a, h, dh)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd runs on cpu or cuda tensors, got "
                         f"{a.device}")
    shape = tuple(a.shape)
    if len(shape) != 3:
        raise ValueError(f"rglru_scan_bwd: a {shape} must be [B, S, D]")
    ac, hc, dhc = _launch.check("rglru_scan_bwd", a.device, [
        ("a", a, torch.float32, shape), ("h", h, torch.float32, shape),
        ("dh", dh, torch.float32, shape)])
    da = torch.empty(shape, dtype=torch.float32, device=a.device)
    du = torch.empty_like(da)
    if da.numel() == 0:
        return da, du
    B, S, D = shape
    _launch.launch("rglru_scan_bwd", a.device, [ac, hc, dhc, da, du],
                   ctypes.c_int64(B), ctypes.c_int64(S), ctypes.c_int64(D))
    rglru_scan_bwd.launches += 1
    return da, du


rglru_scan_bwd.launches = 0
