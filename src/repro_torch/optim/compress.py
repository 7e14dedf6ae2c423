"""Int8 gradient compression with error feedback (a port of
:mod:`repro.optim.compress`).

Used in two places:
  1. Micro-batch gradient accumulation (:mod:`repro_torch.train.step`):
     each microbatch's gradients are quantised to int8 (one scale a
     tensor) before they are added to the f32 accumulator; the
     quantisation residual is carried to the next microbatch (error
     feedback), so the accumulated gradient is unbiased over the window.
  2. Cross-replica reduction (:func:`compressed_psum`): all-reduces of
     the int32-widened int8 payload and of the per-tensor scales over a
     :mod:`torch.distributed` group.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.common.tree import tree_field, tree_map

F32 = torch.float32


class Quantized(NamedTuple):
    q: torch.Tensor        # int8 payload
    scale: torch.Tensor    # f32 per-tensor scale


def quantize(x: torch.Tensor) -> Quantized:
    xf = x.to(F32)
    scale = torch.clamp(torch.max(torch.abs(xf)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return Quantized(q, scale)


def dequantize(qz: Quantized) -> torch.Tensor:
    return qz.q.to(F32) * qz.scale


def quantize_with_feedback(x: torch.Tensor, err: torch.Tensor
                           ) -> Tuple[Quantized, torch.Tensor]:
    """Quantise (x + carried error); return the quantised value and the
    residual to carry forward."""
    target = x.to(F32) + err
    qz = quantize(target)
    return qz, target - dequantize(qz)


def tree_quantize_with_feedback(grads: Any, err_tree: Any
                                ) -> Tuple[Any, Any]:
    """Returns (dequantised grads, new error tree)."""
    def one(g, e):
        qz, new_err = quantize_with_feedback(g, e)
        return dequantize(qz), new_err
    pairs = tree_map(one, grads, err_tree)
    return tree_field(pairs, 0), tree_field(pairs, 1)


def init_error_tree(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The compressed all-reduce of ``x`` over ``group`` (a process group,
    a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` such as
    :func:`repro_torch.launch.mesh.data_mesh`'s, or None for the whole
    world): quantise locally, all-reduce the MAX of the scales and the SUM
    of the int32-widened payloads, dequantise with the max scale.  The
    int8 payload is what a wire would carry; here it is widened before the
    sum, as in the reference."""
    import torch.distributed as dist
    if group is not None and hasattr(group, "get_group"):
        group = group.get_group()
    qz = quantize(x)
    scale = qz.scale.clone()
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q32 = qz.q.to(torch.int32)
    dist.all_reduce(q32, op=dist.ReduceOp.SUM, group=group)
    return q32.to(F32) * scale
