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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.models.layers import blocked_attention

#: the kernels' element types and their codes in ``csrc/``
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
MAX_HEAD_DIM = 256
TENSOR_CORES = "tensor_cores"
CUDA_CORES = "cuda_cores"
#: route -> the kernel's name in ``_build.SOURCES``
KERNELS = {TENSOR_CORES: "flash_attention_tc", CUDA_CORES: "flash_attention"}
#: TMA's global address and strides are multiples of 16 bytes
_TMA_ALIGN = 16


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
    :func:`route` on CUDA tensors."""
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


def reset_launches() -> None:
    """Set the total and every route's count to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(KERNELS, 0)


reset_launches()
