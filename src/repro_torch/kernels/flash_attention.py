"""Forward attention with an online softmax: the CUDA ``flash_attention``
kernels, one for each route (``csrc/flash_attention_tc.cu``,
``csrc/flash_attention.cu``).

Replaces the TPU kernel ``_flash_kernel`` (``flash_attention``,
``src/repro/kernels/flash_attention.py:25,94``): GQA/MQA (Hq = G · Hkv),
causal, sliding window, gemma2's soft-cap, f32 scores and accumulation,
the probabilities rounded to the input type before the PV product,
bf16/f16/f32 inputs, ``head_dim`` up to 256.  A block takes a tile of
query rows (position, head of the group), so the G heads of a group share
each K/V tile from shared memory; tiles outside the causal triangle or
the window are skipped.  Bound on an H100: operations, 4 · D FLOPs for
each (query head, key) pair the masks keep.

Two routes, chosen before launch from the input type and ``head_dim``
alone (:func:`route`); a failed build or launch raises, it never takes
the other route:

* ``"tensor_cores"``: bf16/f16 with ``head_dim`` a multiple of 16.  Both
  products on ``wgmma`` (f32 accumulators), K/V tiles fed by TMA from a
  producer warp, 128 query rows a block (``flash_attention_tc.cu``).
* ``"cuda_cores"``: f32 (no tensor-core path keeps full f32), and a
  16-bit ``head_dim`` that is not a multiple of 16: f32 FMAs, 64 rows a
  block (``flash_attention.cu``).

Its plain version is :func:`repro_torch.models.layers.blocked_attention`,
as the reference's ``kernels/ref.py`` makes ``blocked_attention`` the
Pallas kernel's oracle.  The model's attention blocks call
:func:`flash_attention` where the reference calls ``blocked_attention``.

Gradients flow through a :class:`torch.autograd.Function` whenever grad
mode is on and q, k or v requires grad: its forward is the same route
and launch, and it saves q, k, v and the output; its backward is
:func:`flash_attention_bwd`, two CUDA kernels
(:func:`flash_attention_bwd_dq`, which also writes the rows' log-sum-exp
and rowsum(dO ∘ O), then :func:`flash_attention_bwd_dkdv`), or their
plain version :func:`flash_attention_bwd_plain` on CPU tensors.  The
backward takes the forward's route by the same rule (:data:`BWD_KERNELS`):
``csrc/flash_attention_bwd_tc.cu`` on ``wgmma`` and TMA for the 16-bit
inputs of the tensor-core route, ``csrc/flash_attention_bwd.cu`` (f32
FMAs) for the rest; each kernel counts its ``launches`` and
``launches_by_route``.  The TPU kernel had no backward (the reference
trains through ``jax.grad`` of ``blocked_attention``), so these replace
no TPU kernel.  With grad off, :func:`flash_attention` is the forward
alone, its launches and routes as they were.

The forward and the backward are each one custom op,
``repro_torch::flash_attention`` and ``repro_torch::flash_attention_bwd``
(the Function's forward and backward call them), so that a trace sees
one op a call whatever the device: the route is chosen inside the op.
Each op has a fake kernel (its outputs' shapes), a FLOP formula (the
products of the plain versions at the same shapes:
:func:`forward_flops`, :func:`backward_flops`) and a DTensor sharding
strategy (batch, or heads where both head counts divide the mesh axis or
under MQA, else replicated inputs).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _launch
from repro_torch.models.layers import blocked_attention

#: the kernels' element types and their codes in ``csrc/``
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 256
TENSOR_CORES = "tensor_cores"
CUDA_CORES = "cuda_cores"
#: route -> the kernel's name in ``_build.SOURCES``
KERNELS = {TENSOR_CORES: "flash_attention_tc", CUDA_CORES: "flash_attention"}
#: route -> the backward's kernels (B2 and B3) in ``_build.SOURCES``
BWD_KERNELS = {TENSOR_CORES: "flash_attention_bwd_tc",
               CUDA_CORES: "flash_attention_bwd"}
#: TMA's global address and strides are multiples of 16 bytes
_TMA_ALIGN = 16
#: query positions a step of the plain backward holds against every key
PLAIN_BWD_BLOCK_Q = 512


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The route a CUDA input of ``dtype`` and ``head_dim`` takes:
    :data:`TENSOR_CORES` for bf16/f16 with ``head_dim`` a multiple of 16,
    else :data:`CUDA_CORES`."""
    if dtype in (torch.float16, torch.bfloat16) and head_dim % 16 == 0:
        return TENSOR_CORES
    return CUDA_CORES


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` (contiguous), copied to a fresh buffer if its data pointer
    is not 16-byte aligned."""
    return x if x.data_ptr() % _TMA_ALIGN == 0 else x.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [B,S,Hq,D]; k/v [B,T,Hkv,D]; Hq = G·Hkv.  Returns [B,S,Hq,D] in
    q's type: :func:`blocked_attention` on CPU tensors, the kernel of
    :func:`route` on CUDA tensors (the op ``repro_torch::flash_attention``).
    Under grad mode, with q, k or v requiring grad, through
    :class:`_FlashAttention`, whose backward is :func:`flash_attention_bwd`
    (the op ``repro_torch::flash_attention_bwd``)."""
    _launch.check_device("flash_attention", q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _fwd_op(q, k, v, causal, window, softcap)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, window: int, softcap: float) -> torch.Tensor:
    """The forward of :func:`flash_attention`, counted in its
    ``launches``."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be [B, S, H, D]")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: {q.dtype} is not one of "
                        f"{sorted(map(str, DTYPE_CODES))}")
    if Hkv == 0 or Hq % Hkv or D > MAX_HEAD_DIM or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: needs Hq a multiple of Hkv and "
                         f"head_dim <= {MAX_HEAD_DIM}")
    qc, kc, vc = _launch.check("flash_attention", q.device, [
        ("q", q, q.dtype, (B, S, Hq, D)),
        ("k", k, q.dtype, (B, T, Hkv, D)),
        ("v", v, q.dtype, (B, T, Hkv, D))])
    path = route(q.dtype, D)
    if path == TENSOR_CORES:
        qc, kc, vc = (_aligned(x) for x in (qc, kc, vc))
    out = torch.empty_like(qc)
    if out.numel() == 0:
        return out
    _launch_route(path, qc, kc, vc, out, causal=causal, window=window,
                  softcap=softcap)
    flash_attention.launches += 1
    flash_attention.launches_by_route[path] += 1
    return out


def _launch_route(path: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, out: torch.Tensor, *, causal: bool,
                  window: int, softcap: float) -> None:
    """Launch route ``path``'s kernel on checked contiguous CUDA tensors,
    writing ``out``; counts nothing.  :func:`flash_attention` launches
    through it, and so can a comparison of the two routes on the same
    inputs."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    _launch.launch(KERNELS[path], q.device, [q, k, v, out],
                   *(ctypes.c_int(n) for n in (B, S, T, Hq, Hkv, D)),
                   ctypes.c_int(DTYPE_CODES[q.dtype]),
                   ctypes.c_int(int(bool(causal))), ctypes.c_int(int(window)),
                   ctypes.c_float(float(softcap)),
                   ctypes.c_float(D ** -0.5))


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with :func:`flash_attention_bwd` as its
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out = _fwd_op(q, k, v, causal, window, softcap)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _bwd_op(q, k, v, out, dout, *ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0
                              ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of :func:`flash_attention` at q [B,S,Hq,D], k/v
    [B,T,Hkv,D], its output ``out`` and the output's gradient ``dout``:
    the formulas of ``csrc/flash_attention_bwd.cu`` in f32 torch ops, a
    block of ``PLAIN_BWD_BLOCK_Q`` query positions at a time against every
    key:
    P = exp(s − lse) over the kept keys, dS = P ∘ (dO Vᵀ − rowsum(dO ∘
    O)) (× 1 − (s/cap)² where soft-capped), dQ = scale · dS K, dK =
    scale · dSᵀ Q, dV = Pᵀ dO.  A row with no kept key gets zero
    gradients.  Returned in the inputs' types."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    dev = q.device
    kf, vf = k.float(), v.float()
    dq = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, T, Hkv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    k_pos = torch.arange(T, device=dev)
    for i0 in range(0, S, PLAIN_BWD_BLOCK_Q):
        i1 = min(S, i0 + PLAIN_BWD_BLOCK_Q)
        n = i1 - i0
        qb, ob, gb = (x[:, i0:i1].float().reshape(B, n, Hkv, G, D)
                      for x in (q, out, dout))
        s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kf) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        q_pos = torch.arange(i0, i1, device=dev)[:, None]
        keep = torch.ones((n, T), dtype=torch.bool, device=dev)
        if causal:
            keep &= k_pos[None, :] <= q_pos
        if window > 0:
            keep &= k_pos[None, :] > q_pos - window
        keep5 = keep[None, :, None, None, :]
        lse = torch.logsumexp(torch.where(keep5, s, -torch.inf), dim=-1)
        lse = torch.where(torch.isfinite(lse), lse, 0.0)
        p = torch.where(keep5, torch.exp(s - lse[..., None]), 0.0)
        delta = (gb * ob).sum(-1)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", gb, vf)
        ds = p * (dp - delta[..., None])
        if softcap > 0.0:
            ds = ds * (1.0 - torch.square(s / softcap))
        dq[:, i0:i1] = (torch.einsum("bqhgk,bkhd->bqhgd", ds, kf)
                        * scale).reshape(B, n, Hq, D)
        dk += torch.einsum("bqhgk,bqhgd->bkhd", ds, qb) * scale
        dv += torch.einsum("bqhgk,bqhgd->bkhd", p, gb)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_args(q, k, v, *, causal, window, softcap) -> tuple:
    """The two backward kernels' scalar arguments, in order."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    return (ctypes.c_int(B), ctypes.c_int(S), ctypes.c_int(T),
            ctypes.c_int(Hq), ctypes.c_int(Hkv), ctypes.c_int(D),
            ctypes.c_int(DTYPE_CODES[q.dtype]),
            ctypes.c_int(int(bool(causal))), ctypes.c_int(int(window)),
            ctypes.c_float(float(softcap)), ctypes.c_float(D ** -0.5))


def _bwd_launch_route(path: str, kernel: str, q, k, v, out, dout, lse=None,
                      delta=None, *, causal: bool, window: int,
                      softcap: float) -> Tuple[torch.Tensor, ...]:
    """Launch route ``path``'s B2 (``kernel="dq"``; returns dq, lse,
    delta) or B3 (``kernel="dkdv"``, given B2's lse and delta; returns
    dk, dv) on checked contiguous CUDA tensors; counts nothing.  The
    backward's wrappers launch through it, and so can a comparison of the
    two routes on the same inputs."""
    if path == TENSOR_CORES:
        q, k, v, dout = (_aligned(x) for x in (q, k, v, dout))
        out = None if out is None else _aligned(out)
    if kernel == "dq":
        B, S, Hq, _ = q.shape
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse)
        grads = (torch.empty_like(q),)
        ptrs = [q, k, v, out, dout, lse, delta, grads[0], None, None]
    else:
        grads = (torch.empty_like(k), torch.empty_like(v))
        ptrs = [q, k, v, None, dout, lse, delta, None, *grads]
    name = BWD_KERNELS[path]
    _launch.launch(name, q.device, ptrs,
                   *_bwd_args(q, k, v, causal=causal, window=window,
                              softcap=softcap),
                   entry=f"{name}_{kernel}_launch")
    return grads + (lse, delta) if kernel == "dq" else grads


def flash_attention_bwd_dq(q, k, v, out, dout, *, causal, window, softcap
                           ) -> Tuple[torch.Tensor, ...]:
    """Kernel B2 of :func:`route` on checked contiguous CUDA tensors:
    returns (dq in q's type, lse [B,Hq,S] f32, rowsum(dO ∘ O) [B,Hq,S]
    f32); one launch, counted in ``flash_attention_bwd_dq.launches`` and
    its ``launches_by_route``."""
    path = route(q.dtype, q.shape[-1])
    dq, lse, delta = _bwd_launch_route(path, "dq", q, k, v, out, dout,
                                       causal=causal, window=window,
                                       softcap=softcap)
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.launches_by_route[path] += 1
    return dq, lse, delta


def flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, *, causal, window,
                             softcap) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3 of :func:`route` on checked contiguous CUDA tensors and
    B2's lse and delta: returns (dk, dv) in k's type; one launch, counted
    in ``flash_attention_bwd_dkdv.launches`` and its
    ``launches_by_route``."""
    path = route(q.dtype, q.shape[-1])
    dk, dv = _bwd_launch_route(path, "dkdv", q, k, v, None, dout, lse, delta,
                               causal=causal, window=window, softcap=softcap)
    flash_attention_bwd_dkdv.launches += 1
    flash_attention_bwd_dkdv.launches_by_route[path] += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of :func:`flash_attention`:
    :func:`flash_attention_bwd_plain` on CPU tensors, kernels B2 then B3
    of :func:`route` on CUDA tensors (the inputs of one type, f32, f16 or
    bf16; the gradients in it)."""
    if all(x.device.type == "cpu" for x in (q, k, v, out, dout)):
        return flash_attention_bwd_plain(q, k, v, out, dout, causal=causal,
                                         window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda tensors, "
                         f"got {q.device}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd: {q.dtype} is not one of "
                        f"{sorted(map(str, DTYPE_CODES))}")
    if Hkv == 0 or Hq % Hkv or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: needs Hq a multiple of Hkv and "
                         f"head_dim <= {MAX_HEAD_DIM}")
    qc, kc, vc, oc, gc = _launch.check("flash_attention_bwd", q.device, [
        ("q", q, q.dtype, (B, S, Hq, D)),
        ("k", k, q.dtype, (B, T, Hkv, D)),
        ("v", v, q.dtype, (B, T, Hkv, D)),
        ("out", out, q.dtype, (B, S, Hq, D)),
        ("dout", dout.to(q.dtype), q.dtype, (B, S, Hq, D))])
    if qc.numel() == 0 or kc.numel() == 0:
        return torch.zeros_like(qc), torch.zeros_like(kc), \
            torch.zeros_like(vc)
    kw = dict(causal=causal, window=window, softcap=softcap)
    dq, lse, delta = flash_attention_bwd_dq(qc, kc, vc, oc, gc, **kw)
    dk, dv = flash_attention_bwd_dkdv(qc, kc, vc, gc, lse, delta, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The two custom ops: one op a traced call, whatever the device
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, softcap: float) -> torch.Tensor:
    """The forward as one op: :func:`_forward` (its route chosen by the
    tensors' device)."""
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap)


@_fwd_op.register_fake
def _(q, k, v, causal, window, softcap):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, dout: torch.Tensor, causal: bool, window: int,
            softcap: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward as one op: :func:`flash_attention_bwd`."""
    return flash_attention_bwd(q, k, v, out, dout, causal=causal,
                               window=window, softcap=softcap)


@_bwd_op.register_fake
def _(q, k, v, out, dout, causal, window, softcap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def forward_flops(q_shape, k_shape, block_q: int = 512,
                  block_k: int = 1024) -> int:
    """The products :func:`blocked_attention` computes at these shapes:
    QKᵀ and PV over every (query block, key block) pair, both axes padded
    to their blocks, masked blocks included: 4 · B · Hq · S_pad · T_pad ·
    D."""
    B, S, Hq, D = q_shape
    T = k_shape[1]
    bq, bk = min(block_q, max(S, 1)), min(block_k, max(T, 1))
    return 4 * B * Hq * (-(-S // bq) * bq) * (-(-T // bk) * bk) * D


def backward_flops(q_shape, k_shape) -> int:
    """The products :func:`flash_attention_bwd_plain` computes at these
    shapes: QKᵀ again, dO Vᵀ, dS K, dSᵀ Q and Pᵀ dO, each 2 · B · Hq · S
    · T · D."""
    B, S, Hq, D = q_shape
    return 10 * B * Hq * S * k_shape[1] * D


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, causal, window, softcap, *args,
      **kwargs) -> int:
    return forward_flops(q_shape, k_shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, *args, **kwargs) -> int:
    return backward_flops(q_shape, k_shape)


def _head_shards(q, k) -> bool:
    """Whether both head counts divide every mesh dim's size."""
    return all(q.shape[2] % n == 0 and k.shape[2] % n == 0
               for n in q.mesh.shape)


def _mqa(q, k) -> bool:
    """One KV head and query heads that divide every mesh dim's size."""
    return k.shape[2] == 1 and all(q.shape[2] % n == 0 for n in q.mesh.shape)


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _(q, k, v, causal, window, softcap):
    """Batch shards; heads shard where both head counts divide the axis,
    or under MQA with k/v replicated; else replicated inputs."""
    R, rest = Replicate(), [None] * 3
    out = [([R], [R, R, R] + rest), ([Shard(0)], [Shard(0)] * 3 + rest)]
    if _head_shards(q, k):
        out.append(([Shard(2)], [Shard(2)] * 3 + rest))
    elif _mqa(q, k):
        out.append(([Shard(2)], [Shard(2), R, R] + rest))
    return out


@register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
def _(q, k, v, out, dout, causal, window, softcap):
    """As the forward's; under MQA the one KV head's gradients are
    partial sums over the query heads' shards."""
    R, S0, S2, rest = Replicate(), Shard(0), Shard(2), [None] * 3
    out = [([R] * 3, [R] * 5 + rest), ([S0] * 3, [S0] * 5 + rest)]
    if _head_shards(q, k):
        out.append(([S2] * 3, [S2] * 5 + rest))
    elif _mqa(q, k):
        out.append(([S2, Partial(), Partial()], [S2, R, R, S2, S2] + rest))
    return out


def reset_launches() -> None:
    """Set the forward's total and every route's count, and each backward
    kernel's, to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(KERNELS, 0)
    for fn in (flash_attention_bwd_dq, flash_attention_bwd_dkdv):
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(BWD_KERNELS, 0)


reset_launches()
