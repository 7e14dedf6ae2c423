"""Forward attention with an online softmax: the CUDA ``flash_attention``
kernel (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``_flash_kernel`` (``flash_attention``,
``src/repro/kernels/flash_attention.py:25,94``): GQA/MQA (Hq = G · Hkv),
causal, sliding window, gemma2's soft-cap, f32 scores and accumulation,
the probabilities rounded to the input type before the PV product,
bf16/f16/f32 inputs, ``head_dim`` up to 256.  One CUDA block per
(batch, KV head, tile of 64 query rows), the G heads of a group sharing
each K/V tile from shared memory; tiles outside the causal triangle or
the window are skipped.  Bound on an H100: operations, 4 · D FLOPs for
each (query head, key) pair the masks keep (the source's header says what
the design does about it).

Its plain version is :func:`repro_torch.models.layers.blocked_attention`,
as the reference's ``kernels/ref.py`` makes ``blocked_attention`` the
Pallas kernel's oracle.  The model's attention blocks call
:func:`flash_attention` where the reference calls ``blocked_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.models.layers import blocked_attention

#: the kernel's element types and their codes in ``csrc/flash_attention.cu``
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [B,S,Hq,D]; k/v [B,T,Hkv,D]; Hq = G·Hkv.  Returns [B,S,Hq,D] in
    q's type: :func:`blocked_attention` on CPU tensors, the CUDA kernel
    on CUDA tensors."""
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
    out = torch.empty_like(qc)
    if out.numel() == 0:
        return out
    _launch.launch("flash_attention", q.device, [qc, kc, vc, out],
                   *(ctypes.c_int(n) for n in (B, S, T, Hq, Hkv, D)),
                   ctypes.c_int(DTYPE_CODES[q.dtype]),
                   ctypes.c_int(int(bool(causal))), ctypes.c_int(int(window)),
                   ctypes.c_float(float(softcap)),
                   ctypes.c_float(D ** -0.5))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
