"""Recurrent sequence mixers: RG-LRU (Griffin/RecurrentGemma), mLSTM and
sLSTM (xLSTM) — a port of :mod:`repro.models.recurrent`.

The RG-LRU recurrence h_t = a_t ⊙ h_{t−1} + u_t runs through
:func:`repro_torch.kernels.rglru_scan.rglru_scan`: the CUDA kernel on the
card, its plain sequential loop on the CPU.  The reference computes it
with a jnp associative scan; both are the same function, rounded in
another order (the tests state the tolerance).

mLSTM and sLSTM are plain PyTorch, step for step the reference's plain
``jnp`` (it has no kernel for them): the chunk-parallel mLSTM loops over
chunks where the reference scans, and the sLSTM over time steps on the
host, one step a position.  Their state is float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.layers import activation, einsum, einsum_f32

SQRT_EPS = 1e-6
RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# causal depthwise conv (width K)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x [B,S,D], kernel [K,D] depthwise causal convolution."""
    K, S = kernel.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S, :] * kernel[i]
    return out


def causal_conv1d_step(x_t: torch.Tensor, buf: torch.Tensor,
                       kernel: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. x_t [B,D]; buf [B,K-1,D] (previous inputs)."""
    dt = torch.promote_types(buf.dtype, x_t.dtype)
    window = torch.cat([buf.to(dt), x_t[:, None, :].to(dt)], dim=1)
    y = einsum("bkd,kd->bd", window, kernel)
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, as jnp writes it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def rglru_gates(x: torch.Tensor, params: dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t (decay) and gated input for the linear recurrence.

    r_t = sigmoid(x W_a), i_t = sigmoid(x W_x),
    a_t = exp(-c * softplus(Lambda) * r_t),
    u_t = sqrt(1 - a_t^2) * (i_t * x_t).
    """
    r = torch.sigmoid(einsum("...d,de->...e", x, params["w_a"]))
    i = torch.sigmoid(einsum("...d,de->...e", x, params["w_x"]))
    log_a = -RGLRU_C * softplus(params["lam"]) * r
    a = torch.exp(log_a)
    u = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                   SQRT_EPS)) * (i * x)
    return a, u


def rglru_scan_ref(a: torch.Tensor, u: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear recurrence h_t = a_t*h_{t-1} + u_t over a, u [B,S,D]; h0
    [B,D] an optional initial state, folded into the first step.  Returns
    h [B,S,D] in u's type, the carry in f32 (the kernel on the card)."""
    if h0 is not None:
        u = u.clone()
        u[:, 0] = u[:, 0] + (a[:, 0] * h0).to(u.dtype)
    return rglru_scan(a, u)


def rglru_block(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Griffin recurrent block: gate branch ⊙ (conv → RG-LRU) branch."""
    gate = activation(einsum("bsd,de->bse", x, params["w_gate"]), "gelu")
    rec = einsum("bsd,de->bse", x, params["w_rec"])
    rec = causal_conv1d(rec, params["conv"])
    a, u = rglru_gates(rec, params)
    h = rglru_scan_ref(a, u)
    return einsum("bse,ed->bsd", h * gate, params["w_out"])


class RGLRUState(NamedTuple):
    h: torch.Tensor        # [B, Dr] f32
    conv: torch.Tensor     # [B, K-1, Dr]


def rglru_block_step(x_t: torch.Tensor, state: RGLRUState, params: dict
                     ) -> Tuple[torch.Tensor, RGLRUState]:
    """Decode step. x_t [B,D]."""
    gate = activation(einsum("bd,de->be", x_t, params["w_gate"]), "gelu")
    rec = einsum("bd,de->be", x_t, params["w_rec"])
    rec, conv = causal_conv1d_step(rec, state.conv, params["conv"])
    a, u = rglru_gates(rec, params)
    h = a * state.h + u
    y = einsum("be,ed->bd", h * gate, params["w_out"])
    return y, RGLRUState(h, conv)


def rglru_init_state(batch: int, d_rec: int, conv_k: int,
                     dtype: torch.dtype = torch.float32,
                     device: DeviceLike = "cuda") -> RGLRUState:
    """A zero decode state: h [batch, d_rec], the conv buffer [batch,
    conv_k - 1, d_rec], on ``device`` (the card by default)."""
    dev = resolve_device(device)
    return RGLRUState(torch.zeros((batch, d_rec), dtype=dtype, device=dev),
                      torch.zeros((batch, conv_k - 1, d_rec), dtype=dtype,
                                  device=dev))



# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM) — chunked gated-linear-attention form
# ---------------------------------------------------------------------------

def _pad_seq(x: torch.Tensor, pad: int, value: float) -> torch.Tensor:
    """x padded along axis 1 by ``pad`` entries of ``value``."""
    shape = list(x.shape)
    shape[1] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=1)


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   log_f: torch.Tensor, log_i: torch.Tensor,
                   chunk: int = 128) -> torch.Tensor:
    """Chunk-parallel mLSTM.

    q,k,v [B,S,H,D]; log_f/log_i [B,S,H] (log forget / input gates, f32).
    C_t = f_t C_{t-1} + i_t v_t k_t^T ; y_t = C_t q_t / max(|n_t.q_t|,1).
    S is padded to a multiple of ``chunk`` (q, k, v and log_f with 0,
    log_i with -1e9, in f32); the state between chunks is f32.  Returns
    y [B,S,H,D] in q's type.
    """
    B, S, H, D = q.shape
    pad = (-S) % chunk
    if pad:
        q, k, v = (_pad_seq(x, pad, 0.0) for x in (q, k, v))
        log_f = _pad_seq(log_f, pad, 0.0)
        log_i = _pad_seq(log_i, pad, -1e9)
    n_chunks = q.shape[1] // chunk
    scale = D ** -0.5
    dev = q.device
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=dev))
    causal_f = causal.float()[None, None]              # [1,1,c,c]
    S_state = torch.zeros((B, H, D, D), dtype=torch.float32, device=dev)
    n_state = torch.zeros((B, H, D), dtype=torch.float32, device=dev)
    m_state = torch.zeros((B, H), dtype=torch.float32, device=dev)
    ys = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        qq, kk, vv, lf, li = (x[:, sl] for x in (q, k, v, log_f, log_i))
        qf, kf, vf = qq.float(), kk.float(), vv.float()
        cf = torch.cumsum(lf, dim=1)                         # [B,c,H]
        total_f = cf[:, -1]                                  # [B,H]
        m_intra = (li - cf).amax(dim=1)                      # [B,H]
        m_new = torch.maximum(m_state + total_f, m_intra + total_f)

        qk = einsum_f32("bthd,bshd->bhts", qq, kk) * scale
        dmat = cf[:, :, None, :] - cf[:, None, :, :] + li[:, None, :, :]
        dmat = dmat.movedim(3, 1)                            # [B,H,t,s]
        dmat = torch.where(causal[None, None], dmat, -1e30)
        inter_log = cf.movedim(2, 1) + m_state[..., None]    # [B,H,t]
        m_row = torch.maximum(dmat.amax(dim=-1), inter_log)
        w_intra = torch.exp(dmat - m_row[..., None])
        w_inter = torch.exp(inter_log - m_row)
        y_intra = torch.einsum("bhts,bhts,bshd->bthd", causal_f,
                               w_intra * qk, vf)
        y_inter = torch.einsum("bthd,bhde,bht->bthe", qf, S_state,
                               w_inter) * scale
        # "* 0 + w_intra" as the reference writes it: a non-finite qk
        # reaches n_intra
        n_intra = torch.einsum("bhts,bshd->bthd", w_intra * qk * 0 + w_intra,
                               kf) * scale
        n_row = torch.einsum("bthd,bthd->bth", qf, n_intra) + torch.einsum(
            "bthd,bhd,bht->bth", qf, n_state, w_inter) * scale
        denom = torch.maximum(n_row.abs(), torch.exp(-m_row.permute(0, 2, 1)))
        y = (y_intra + y_inter) / denom[..., None]

        # state update (relative to m_new)
        decay_state = torch.exp(m_state + total_f - m_new)   # [B,H]
        w_tok = torch.exp((total_f[:, None] - cf) + li - m_new[:, None])
        S_state = (S_state * decay_state[..., None, None]
                   + torch.einsum("bshd,bsh,bshe->bhde", kf, w_tok, vf))
        n_state = (n_state * decay_state[..., None]
                   + torch.einsum("bshd,bsh->bhd", kf, w_tok))
        m_state = m_new
        ys.append(y.to(q.dtype))
    return torch.cat(ys, dim=1)[:, :S]


class MLSTMState(NamedTuple):
    S: torch.Tensor   # [B,H,D,D] f32
    n: torch.Tensor   # [B,H,D] f32
    m: torch.Tensor   # [B,H] f32


def mlstm_step(q, k, v, log_f, log_i, state: MLSTMState
               ) -> Tuple[torch.Tensor, MLSTMState]:
    """Decode step; q,k,v [B,H,D]; gates [B,H]."""
    D = q.shape[-1]
    scale = D ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    m_new = torch.maximum(state.m + log_f, log_i)
    decay = torch.exp(state.m + log_f - m_new)
    inw = torch.exp(log_i - m_new)
    S_new = (state.S * decay[..., None, None]
             + einsum_f32("bhd,bhe->bhde", kf, vf) * inw[..., None, None])
    n_new = state.n * decay[..., None] + kf * inw[..., None]
    num = einsum_f32("bhd,bhde->bhe", qf, S_new) * scale
    den = einsum_f32("bhd,bhd->bh", qf, n_new).abs() * scale
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return y.to(q.dtype), MLSTMState(S_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with exponential gating) — sequential
# ---------------------------------------------------------------------------

SLSTMState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def slstm_init_state(batch: int, d: int, device=None) -> SLSTMState:
    """(c, n, h, m), each [batch, d] f32; n starts at 1e-6."""
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return (z, z + 1e-6, z, z)


def slstm_seq(x: torch.Tensor, params: dict,
              state: Optional[SLSTMState] = None
              ) -> Tuple[torch.Tensor, SLSTMState]:
    """x [B,S,D].  The recurrence one position at a time (the gates
    depend on h_{t-1} through R, so it is not parallelisable), in f32
    with the block's f32 weights.  Returns (h [B,S,D] in x's type, the
    final (c, n, h, m))."""
    B, S, D = x.shape
    wz, wi, wf, wo = (params[k] for k in ("w_z", "w_i", "w_f", "w_o"))
    rz, ri, rf, ro = (params[k] for k in ("r_z", "r_i", "r_f", "r_o"))
    if state is None:
        state = slstm_init_state(B, D, x.device)
    c, n, h, m = state
    hs = []
    for t in range(S):
        xf = x[:, t].float()
        zt = torch.tanh(xf @ wz + h @ rz)
        it = xf @ wi + h @ ri
        ft = xf @ wf + h @ rf
        ot = torch.sigmoid(xf @ wo + h @ ro)
        m_new = torch.maximum(ft + m, it)
        i_e = torch.exp(it - m_new)
        f_e = torch.exp(ft + m - m_new)
        c = f_e * c + i_e * zt
        n = f_e * n + i_e
        h = ot * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), (c, n, h, m)
