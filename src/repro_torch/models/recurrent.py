"""The RG-LRU recurrent block of Griffin/RecurrentGemma (a port of the
RG-LRU half of :mod:`repro.models.recurrent`; mLSTM and sLSTM are not
ported yet, ROADMAP A.6).

The recurrence h_t = a_t ⊙ h_{t−1} + u_t runs through
:func:`repro_torch.kernels.rglru_scan.rglru_scan`: the CUDA kernel on the
card, its plain sequential loop on the CPU.  The reference computes it
with a jnp associative scan; both are the same function, rounded in
another order (the tests state the tolerance).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.layers import activation, einsum

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

