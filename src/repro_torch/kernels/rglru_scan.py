"""The RG-LRU linear recurrence: the CUDA ``rglru_scan`` kernel
(``csrc/rglru_scan.cu``), its backward ``rglru_scan_bwd`` on two routes
(``csrc/rglru_scan_bwd_tma.cu``, ``csrc/rglru_scan_bwd.cu``) and their
plain PyTorch versions.

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

The backward's two routes compute the same function bitwise; the
inputs' shape and alignment choose between them before launch
(:func:`route`), and a failed encode or launch raises, it never takes
the other route:

* ``tma_ring`` (``csrc/rglru_scan_bwd_tma.cu``): a producer warp brings
  tiles of :data:`TMA_TILE_STEPS` steps × :data:`TMA_TILE_CHANNELS`
  channels by TMA into a ring in shared memory, a consumer warp runs the
  chain over them.  TMA needs 16-byte aligned strides and addresses: D a
  multiple of 4 and every pointer 16-byte aligned (every model width).
* ``thread_loads`` (``csrc/rglru_scan_bwd.cu``): one thread a channel
  loading its own steps, for every other input (odd widths, a view that
  starts 4 bytes into its storage).

``rglru_scan_bwd.launches`` counts the backward's launches and
``rglru_scan_bwd.launches_by_route`` each route's.

The forward's f32 output and the backward are each one custom op,
``repro_torch::rglru_scan`` and ``repro_torch::rglru_scan_bwd`` (the
Function's forward and backward call them), so that a trace sees one op
a call whatever the device: the route is chosen inside the op.  Each op
has a fake kernel (its outputs' shapes) and a DTensor sharding strategy
(batch and channels shard, time never does); the recurrence has no
products, so no FLOP formula.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels import _launch

TMA_RING = "tma_ring"
THREAD_LOADS = "thread_loads"
#: route -> the backward's kernel in ``_build.SOURCES``
BWD_KERNELS = {TMA_RING: "rglru_scan_bwd_tma", THREAD_LOADS: "rglru_scan_bwd"}
#: the TMA route's tile: steps and channels of a box (``kSteps`` and
#: ``kChannels`` in its source)
TMA_TILE_STEPS = 16
TMA_TILE_CHANNELS = 32
_TMA_ALIGN = 16


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
        h = _scan_op(a, u)
        ctx.save_for_backward(a.float(), h)
        ctx.types = (a.dtype, u.dtype)
        return h.to(u.dtype)

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, du = _bwd_op(a, h, dh.float())
        a_type, u_type = ctx.types
        return da.to(a_type), du.to(u_type)


def rglru_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`rglru_scan_plain` on CPU tensors; the CUDA kernel on CUDA
    tensors (a and u cast to f32 first, the result in u's type).  Under
    grad mode, with a or u requiring grad, through :class:`_RGLRUScan`,
    whose backward is :func:`rglru_scan_bwd`."""
    _launch.check_device("rglru_scan", a, u)
    if torch.is_grad_enabled() and (a.requires_grad or u.requires_grad):
        return _RGLRUScan.apply(a, u)
    return _scan_op(a, u).to(u.dtype)


def rglru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor,
                         dh: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's backward in f32, time reversed: g_{S-1} =
    dh_{S-1}, g_t = fma(a_{t+1}, g_{t+1}, dh_t); du = g and da_t = g_t ·
    h_{t-1} with h_{-1} = 0.  a, h (the forward's f32 output) and dh are
    f32 [B, S, D]; returns (da, du), f32.  Each step is rounded as
    both routes' kernels round it (one FMA, one product), so the three
    agree bitwise."""
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


def route(D: int, tensors) -> str:
    """The backward's route for D channels and the CUDA tensors it passes
    (a, h, dh, da, du, contiguous): ``tma_ring`` when D is a multiple of
    4 and every data pointer is 16-byte aligned (TMA's strides and base
    addresses), else ``thread_loads``.  A choice by shape and alignment,
    made before launch."""
    if D % 4 == 0 and all(x.data_ptr() % _TMA_ALIGN == 0 for x in tensors):
        return TMA_RING
    return THREAD_LOADS


def _bwd_launch_route(path: str, a, h, dh, da, du) -> None:
    """Launch route ``path``'s kernel on checked contiguous f32 CUDA
    tensors [B, S, D], writing da and du; counts nothing.
    :func:`rglru_scan_bwd` launches through it, and so can a comparison
    of the two routes on the same inputs."""
    B, S, D = a.shape
    _launch.launch(BWD_KERNELS[path], a.device, [a, h, dh, da, du],
                   ctypes.c_int64(B), ctypes.c_int64(S), ctypes.c_int64(D))


def _bwd_launch(a, h, dh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, du) by the kernel of :func:`route` on checked contiguous f32
    CUDA tensors; one launch, counted in ``rglru_scan_bwd.launches`` and
    its ``launches_by_route``."""
    da = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    du = torch.empty_like(da)
    if da.numel() == 0:
        return da, du
    path = route(a.shape[2], (a, h, dh, da, du))
    _bwd_launch_route(path, a, h, dh, da, du)
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.launches_by_route[path] += 1
    return da, du


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, du) of the recurrence, f32 [B, S, D]:
    :func:`rglru_scan_bwd_plain` on CPU tensors, the kernel of
    :func:`route` on CUDA tensors (one launch, counted)."""
    if all(x.device.type == "cpu" for x in (a, h, dh)):
        return rglru_scan_bwd_plain(a, h, dh)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd runs on cpu or cuda tensors, got "
                         f"{a.device}")
    shape = tuple(a.shape)
    if len(shape) != 3:
        raise ValueError(f"rglru_scan_bwd: a {shape} must be [B, S, D]")
    return _bwd_launch(*_launch.check("rglru_scan_bwd", a.device, [
        ("a", a, torch.float32, shape), ("h", h, torch.float32, shape),
        ("dh", dh, torch.float32, shape)]))


# ---------------------------------------------------------------------------
# The two custom ops: one op a traced call, whatever the device
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _scan_op(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The forward's f32 output as one op: :func:`_scan_f32` (its route
    chosen by the tensors' device)."""
    return _scan_f32(a, u)


@_scan_op.register_fake
def _(a, u):
    return torch.empty(a.shape, dtype=torch.float32, device=a.device)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def _bwd_op(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward as one op: :func:`rglru_scan_bwd`."""
    return rglru_scan_bwd(a, h, dh)


@_bwd_op.register_fake
def _(a, h, dh):
    f32 = dict(dtype=torch.float32, device=a.device)
    return torch.empty(a.shape, **f32), torch.empty(a.shape, **f32)


def _scan_shardings(n_in: int, n_out: int):
    """Batch (dim 0) and channels (dim 2) shard; time never does."""
    return [([p] * n_out, [p] * n_in) for p in (Replicate(), Shard(0),
                                                Shard(2))]


@register_sharding(torch.ops.repro_torch.rglru_scan.default)
def _(a, u):
    return _scan_shardings(2, 1)


@register_sharding(torch.ops.repro_torch.rglru_scan_bwd.default)
def _(a, h, dh):
    return _scan_shardings(3, 2)


def reset_launches() -> None:
    """Set the forward's and the backward's counts, and each of the
    backward's routes', to 0."""
    rglru_scan.launches = 0
    rglru_scan_bwd.launches = 0
    rglru_scan_bwd.launches_by_route = dict.fromkeys(BWD_KERNELS, 0)


reset_launches()
