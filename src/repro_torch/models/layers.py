"""Shared layers of the port's language model: norms, RoPE and
Qwen2-VL's 3-axis M-RoPE, the gated MLP and attention (a port of
:mod:`repro.models.layers`).

Types follow JAX's promotion at each op, written out because
``torch.einsum`` refuses mixed types: a product of two bf16 tensors is
bf16 (accumulated in f32), a bf16 × f32 product is f32, and where the
reference asks for ``preferred_element_type=float32`` both operands are
taken to f32 (a bf16 product is exact in f32, so this is the same sum).

:func:`blocked_attention` is the plain version of the CUDA
``flash_attention`` kernel (:mod:`repro_torch.kernels.flash_attention`),
as the reference's ``kernels/ref.py`` makes it the Pallas kernel's
oracle.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.act_shard import constrain

NEG_INF = -1e30


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' promoted type, as ``jnp.einsum``
    computes it without ``preferred_element_type``."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return _einsum(eq, *(o.to(dt) for o in ops))


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; on DTensors sharded on batch letters only
    (letters of every operand and of the output), each rank's shards by
    themselves.  ``torch.einsum`` flattens the batch letters into one
    dimension: a strided shard where an inner one is sharded, which
    DTensor's batched product has no strategy for (and which older
    DTensors refuse to make).  The products are the same."""
    if any(isinstance(o, DTensor) for o in ops):
        out = _local_einsum(eq, ops)
        if out is not None:
            return out
    return torch.einsum(eq, *ops)


def _local_einsum(eq: str, ops) -> Optional[torch.Tensor]:
    """:func:`_einsum`'s shard-local product, or None where it does not
    apply (an ellipsis, no sharded letter, or a sharded letter that is
    not a batch letter)."""
    if "..." in eq or "->" not in eq:
        return None
    terms, out = eq.replace(" ", "").split("->")
    terms = terms.split(",")
    batch = set(out).intersection(*map(set, terms))
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    letters = []
    for i in range(mesh.ndim):
        here = {t[o.placements[i].dim] for t, o in zip(terms, ops)
                if isinstance(o, DTensor) and isinstance(o.placements[i],
                                                         Shard)}
        if not here <= batch or len(here) > 1:
            return None
        letters.append(here.pop() if here else None)
    if not any(letters):
        return None

    def places(term):
        return [Shard(term.index(c)) if c else Replicate() for c in letters]
    local = []
    for t, o in zip(terms, ops):
        if not isinstance(o, DTensor):
            o = DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        local.append(o.redistribute(mesh, places(t)).to_local())
    return DTensor.from_local(torch.einsum(eq, *local), mesh, places(out),
                              run_check=False)


def heads_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., H, e] · w [H, e, D] → [..., D] (``"...he,hed->...d"``),
    the heads flattened into one contraction, with any shard of ``e``
    of a DTensor gathered: an einsum over two contraction dims, or a
    flattened (H, e) with ``e`` sharded, is a strided shard that
    DTensor's batched product has no strategy for."""
    return einsum("...k,kd->...d", _whole(x, x.dim() - 1).flatten(-2),
                  _whole(w, 1).flatten(0, 1))


def _heads_as_cache(q: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """A DTensor q [B,1,Hq,D] with its heads gathered on every mesh dim
    where the cache's KV heads are not sharded: splitting Hq into (Hkv,
    G) keeps a shard only where Hkv carries it (GQA with Hkv below the
    axis size shards the cache's sequence instead)."""
    if not isinstance(q, DTensor):
        return q
    keep = {i for i, p in enumerate(cache.placements)
            if isinstance(p, Shard) and p.dim == 2} \
        if isinstance(cache, DTensor) else set()
    return _whole(q, 2, keep)


def _whole(x: torch.Tensor, dim: int, keep=frozenset()) -> torch.Tensor:
    """A DTensor with its shards of ``dim`` gathered, but on the mesh dims
    in ``keep``; anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    places = [Replicate() if isinstance(p, Shard) and p.dim == dim
              and i not in keep else p for i, p in enumerate(x.placements)]
    if places == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, places)


def einsum_f32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=jnp.float32)``."""
    return _einsum(eq, *(o.float() for o in ops))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dt)


def layernorm_nonparam(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale, no bias)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt)


def apply_norm(kind: str, x: torch.Tensor,
               scale: Optional[torch.Tensor]) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    if kind == "nonparam_ln":
        return layernorm_nonparam(x)
    if kind == "layernorm":
        y = layernorm_nonparam(x)
        if scale is not None:
            y = y * (1.0 + scale.to(y.dtype))
        return y
    raise ValueError(f"unknown norm kind {kind}")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S] (broadcastable)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # [D/2]
    ang = positions[..., None].float() * freqs            # [..., S, D/2]
    ang = ang[..., None, :]                               # [..., S, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: tuple = (1, 1, 2),
                theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the head-dim frequency bands are split
    across (temporal, height, width) position axes.

    x [B, S, H, D]; positions3 [3, B, S].  ``sections`` are relative
    proportions of the D/2 frequency bands: band i takes
    ``half * sections[i] // sum(sections)`` of them, the last the rest.
    With the three axes equal this is :func:`apply_rope`.
    """
    half = x.shape[-1] // 2
    total = sum(sections)
    sizes = [half * s // total for s in sections]
    sizes[-1] = half - sizes[0] - sizes[1]
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # [D/2]
    band = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                      for i, n in enumerate(sizes)])           # [D/2]
    # each frequency band takes its axis' positions: [B, S, D/2]
    pos_sel = positions3.to(x.device)[band].movedim(0, -1)
    ang = (pos_sel.float() * freqs)[..., None, :]             # [B,S,1,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def activation(g: torch.Tensor, act: str) -> torch.Tensor:
    """``jax.nn.silu`` or ``jax.nn.gelu`` (tanh approximation, JAX's
    default)."""
    if act == "silu":
        return F.silu(g)
    if act == "gelu":
        return F.gelu(g, approximate="tanh")
    raise ValueError(act)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on DTensors the same function as
    ``-softplus(-x)`` (DTensor has no strategy for ``log_sigmoid``'s
    forward op)."""
    if isinstance(x, DTensor):
        return -F.softplus(-x)
    return F.logsigmoid(x)


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU/GeGLU block: (act(x·Wg) ⊙ x·Wu)·Wd."""
    g = activation(constrain(einsum("bsd,df->bsf", x, w_gate), "bsf"), act)
    u = constrain(einsum("bsd,df->bsf", x, w_up), "bsf")
    return constrain(einsum("bsf,fd->bsd", g * u, w_down), "bsd")


# ---------------------------------------------------------------------------
# Blocked online-softmax attention (the plain version of flash_attention)
# ---------------------------------------------------------------------------

def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0.0 else s


def _pad_axis(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: int = 0, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      block_q: int = 512, block_k: int = 1024
                      ) -> torch.Tensor:
    """Memory-efficient attention, block for block the reference's.

    q [B,S,Hq,D], k/v [B,T,Hkv,D] with Hq = G·Hkv (GQA).  ``window`` > 0
    is sliding-window attention of that width, ``softcap`` > 0 gemma2's
    logit soft-capping.  Scores and the online softmax (m, l, acc) are
    f32; the probabilities are rounded to v's type before the PV
    product, as the reference does.  Never holds more than
    [B, block_q, Hq, block_k] scores.
    """
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    scale = Dh ** -0.5
    dev = q.device
    block_q = min(block_q, max(S, 1))
    block_k = min(block_k, max(T, 1))
    qp = _pad_axis(q, 1, block_q)
    kp = _pad_axis(k, 1, block_k)
    vp = _pad_axis(v, 1, block_k)
    Sp, Tp = qp.shape[1], kp.shape[1]
    nq, nk = Sp // block_q, Tp // block_k
    qb = qp.reshape(B, nq, block_q, Hkv, G, Dh)
    kb = kp.reshape(B, nk, block_k, Hkv, Dh)
    vb = vp.reshape(B, nk, block_k, Hkv, Dh)
    rows = torch.arange(block_q, dtype=torch.int32, device=dev)
    cols = torch.arange(block_k, dtype=torch.int32, device=dev)
    outs = []
    for qi in range(nq):
        qblk = qb[:, qi].float()                    # [B,bq,Hkv,G,D]
        q_pos = q_offset + qi * block_q + rows
        valid_q = (qi * block_q + rows) < S
        m = torch.full((B, block_q, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, block_q, Hkv, G), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, block_q, Hkv, G, Dh), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_pos = ki * block_k + cols
            s = torch.einsum("bqhgd,bkhd->bqhgk", qblk,
                             kb[:, ki].float()) * scale
            s = _softcap(s, softcap)
            if causal:
                mask = k_pos[None, :] <= q_pos[:, None]
            else:
                mask = torch.ones((block_q, block_k), dtype=torch.bool,
                                  device=dev)
            if window > 0:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            mask = mask & (k_pos[None, :] < T)
            mask5 = mask[None, :, None, None, :]
            s = torch.where(mask5, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            # guard fully masked rows (m_new == NEG_INF)
            m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask5, p, 0.0)
            alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(v.dtype).float(),
                vb[:, ki].float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-20)[..., None]
        out = out * valid_q[None, :, None, None, None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sp, Hq, Dh)[:, :S]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Single-position attention against a KV cache.

    q [B,1,Hq,D]; caches [B,T,Hkv,D]; ``cache_len`` [B]: the number of
    valid entries (the new token already written at cache_len-1).
    """
    B, _, Hq, Dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qr = _heads_as_cache(q, k_cache).reshape(B, Hkv, G, Dh)
    s = einsum_f32("bhgd,bkhd->bhgk", qr, k_cache) * (Dh ** -0.5)
    s = _softcap(s, softcap)
    k_pos = torch.arange(T, dtype=torch.int32, device=q.device)
    cl = cache_len.reshape(-1, 1).to(q.device)
    mask = k_pos[None, :] < cl
    if window > 0:
        mask = mask & (k_pos[None, :] >= cl - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = einsum_f32("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)
