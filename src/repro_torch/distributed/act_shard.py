"""Contextual activation-sharding constraints (a port of
:mod:`repro.distributed.act_shard`), on DTensor placements.

Left to itself, a sharding propagator may reshard the activations across
the FSDP axis where gathering the far smaller weight shards would do.
Pinning the canonical activation layouts keeps the intended ZeRO-3 +
Megatron pattern: :func:`constrain` redistributes a DTensor activation
to its kind's layout, and :func:`gather_weights` all-gathers a period's
FSDP-sharded weights once (its backward is the reduce-scatter of their
gradients), where the reference gets both from GSPMD.

The dry run sets the context (:func:`activation_sharding`); where no
context is set, or on a plain tensor, every call returns its argument as
it is, so model code stays mesh-agnostic and no number of any other path
changes.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import axis_entry, to_placements

_CTX: Optional[dict] = None


def set_context(batch_axes: Tuple[str, ...], tp_axis: str,
                tp_size: int, batch_size: int = 1,
                fsdp_axis: str = "", fsdp_size: int = 1,
                mode: str = "train",
                gather_axes: Tuple[str, ...] = ()) -> None:
    """``gather_axes``: the mesh axes the parameters are FSDP-sharded
    over, which :func:`gather_weights` gathers (none in decode, where the
    weights stay where they are)."""
    global _CTX
    _CTX = {"batch": tuple(batch_axes), "tp": tp_axis, "tp_size": tp_size,
            "batch_size": batch_size, "fsdp": fsdp_axis,
            "fsdp_size": fsdp_size, "mode": mode,
            "gather": tuple(gather_axes)}


def batch_groups() -> int:
    """Product of the batch axes' sizes (1 when unset): the MoE grouped
    dispatch builds one capacity slice a batch shard, so that its
    scatter and gather never cross data shards."""
    return _CTX["batch_size"] if _CTX else 1


def clear_context() -> None:
    global _CTX
    _CTX = None


@contextlib.contextmanager
def activation_sharding(batch_axes: Tuple[str, ...], tp_axis: str,
                        tp_size: int, batch_size: int = 1,
                        fsdp_axis: str = "", fsdp_size: int = 1,
                        mode: str = "train",
                        gather_axes: Tuple[str, ...] = ()):
    set_context(batch_axes, tp_axis, tp_size, batch_size, fsdp_axis,
                fsdp_size, mode, gather_axes)
    try:
        yield
    finally:
        clear_context()


def _tp_if(dim: int):
    if _CTX is None or not _CTX["tp"]:
        return None
    return _CTX["tp"] if dim % _CTX["tp_size"] == 0 else None


def _group_if(dim: int):
    if _CTX is None or not _CTX["batch"]:
        return None
    return axis_entry(_CTX["batch"]) if dim % _CTX["batch_size"] == 0 \
        else None


def spec_for(shape: Tuple[int, ...], kind: str) -> Optional[tuple]:
    """The layout of an activation of ``shape`` and ``kind`` under the
    context, as a spec (None without a context or for an unknown kind).

    kinds: 'bsd' [B,S,D] — batch-sharded, D replicated (the residual
           stream; in decode D over the fsdp axis)
           'bsf' [B,S,F] — MLP hidden, F over tp
           'bshe' [B,S,H,e] — attention heads over tp
           'bsv' [B,S,V] — logits, vocab over tp
           'gecd' [G,E_pad,C_g,D], 'gecf' [G,E_pad,C_g,F] — the MoE
           buffer and hidden, groups over the batch axes (F over tp)
           'gtd' [G,T_g,D] — grouped tokens
    """
    if _CTX is None:
        return None
    b = axis_entry(_CTX["batch"]) if _CTX["batch"] else None
    if kind == "bsd":
        if _CTX["mode"] == "decode":
            # decode: the residual stream feature-sharded over the fsdp
            # axis, so that the weight shards stay where they are
            fa = _CTX["fsdp"] if (_CTX["fsdp"] and
                                  shape[-1] % _CTX["fsdp_size"] == 0) \
                else None
            return (None, None, fa)
        return (b, None, None)
    if kind == "bsf":
        return (b, None, _tp_if(shape[-1]))
    if kind == "bshe":
        return (b, None, _tp_if(shape[-2]), None)
    if kind == "bsv":
        return (b, None, _tp_if(shape[-1]))
    if kind == "gecd":
        return (_group_if(shape[0]), None, None, None)
    if kind == "gecf":
        return (_group_if(shape[0]), None, None, _tp_if(shape[-1]))
    if kind == "gtd":
        return (_group_if(shape[0]), None, None)
    return None


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Pin a canonical activation layout: a DTensor under a context is
    redistributed to :func:`spec_for`'s placements; anything else is
    returned as it is."""
    if _CTX is None or not isinstance(x, DTensor):
        return x
    spec = spec_for(tuple(x.shape), kind)
    if spec is None:
        return x
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def lookup_table(table: torch.Tensor) -> torch.Tensor:
    """The embedding table a token lookup reads: outside decode under a
    context, a DTensor table whole on every rank (a lookup into a
    vocabulary shard gives a masked partial sum, whose gradient DTensor
    cannot add to the tied unembedding's plain partial sum); in decode,
    or anything else, the table as it is."""
    if _CTX is None or _CTX["mode"] == "decode" or \
            not isinstance(table, DTensor):
        return table
    return table.redistribute(table.device_mesh,
                              [Replicate()] * table.device_mesh.ndim)


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending partial sums reduced to a replicated value
    (an all-reduce); anything else as it is."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def _gathered(x: Any) -> Any:
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    placements = tuple(
        Replicate() if isinstance(p, Shard) and names[i] in _CTX["gather"]
        else p for i, p in enumerate(x.placements))
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def gather_weights(tree: Any) -> Any:
    """A period's parameter tree with every DTensor leaf's shards over
    the context's ``gather_axes`` gathered (ZeRO-3's all-gather; its
    backward is the reduce-scatter of the gradients).  Without a context,
    in decode, or with no gather axes, the tree as it is."""
    if _CTX is None or not _CTX["gather"] or _CTX["mode"] == "decode":
        return tree
    if isinstance(tree, dict):
        return {k: gather_weights(v) for k, v in tree.items()}
    return _gathered(tree)
