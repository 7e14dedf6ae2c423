"""Name-based sharding rules with divisibility awareness (a port of
:mod:`repro.distributed.sharding`), over a
:class:`~torch.distributed.device_mesh.DeviceMesh`.

Axes:
  * batch axes  — ("pod", "data") on the multi-pod mesh, ("data",) on one
                  pod
  * fsdp axis   — "data": parameters are also sharded over the data axis
                  (ZeRO-3) on their non-TP dimension
  * tp axis     — "model": attention heads, FFN hidden, experts, vocab

A dimension is sharded only when its size divides by the axis size; the
skipped decisions are recorded in :attr:`ShardingRules.skipped` so that
the dry run can report them.

A spec is a tuple with one entry a tensor dimension, as a
``PartitionSpec`` is: an axis name, a tuple of names, or None (not
sharded), a lone axis written as its name; ``()`` leaves the whole
tensor replicated.
:func:`to_placements` turns a spec into DTensor placements, one
``Shard(d)`` or ``Replicate()`` a mesh dimension.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.common.tree import map_with_paths

Spec = Tuple[Any, ...]

# rule table: basename regex -> per-trailing-dim roles
# roles: "fsdp" | "tp" | None
_PARAM_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"embed$", ("tp", "fsdp")),
    (r"lm_head$", ("fsdp", "tp")),
    (r"(x_)?wq$", ("fsdp", "tp", None)),
    (r"(x_)?wk$", ("fsdp", "tp", None)),
    (r"(x_)?wv$", ("fsdp", "tp", None)),
    (r"(x_)?wo$", ("tp", None, "fsdp")),
    (r"w_gate$", ("fsdp", "tp")),
    (r"w_up$", ("fsdp", "tp")),
    (r"w_down$", ("tp", "fsdp")),
    (r"shared_gate$", ("fsdp", "tp")),
    (r"shared_up$", ("fsdp", "tp")),
    (r"shared_down$", ("tp", "fsdp")),
    (r"router$", ("fsdp", None)),
    (r"w_rec$", ("fsdp", "tp")),
    (r"w_a$", ("fsdp", "tp")),
    (r"w_x$", ("fsdp", "tp")),
    (r"w_out$", ("tp", "fsdp")),
    (r"lam$", ("tp",)),
    (r"conv$", (None, "tp")),
    (r"w_if$", ("fsdp", None)),
    (r"w_og$", ("fsdp", "tp")),
    (r"[wr]_[zifo]$", ("fsdp", "tp")),
    (r"(ln1|ln2|ln_x|final_norm|enc_norm)$", (None,)),
]

# MoE expert-stacked tensors: the expert dim replicated, D/F sharded like
# the dense MLP (the weights are gathered once a layer)
_MOE_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"w_gate$", (None, "fsdp", "tp")),
    (r"w_up$", (None, "fsdp", "tp")),
    (r"w_down$", (None, "tp", "fsdp")),
]


def _map(fn, tree):
    """``fn(path, leaf)`` over a nested dict; anything else is a leaf."""
    return map_with_paths(fn, tree, lambda x: not isinstance(x, dict))


def _prod(sizes) -> int:
    return int(math.prod(sizes))


def axis_entry(axes: Tuple[str, ...]):
    """A spec entry for ``axes``: the name alone for one axis, as
    ``PartitionSpec`` writes it."""
    return axes[0] if len(axes) == 1 else axes


@dataclasses.dataclass
class ShardingRules:
    """The rules for one mesh.  ``layout="default"``: FSDP over data and
    TP over model (for models above ~5B parameters); ``"fsdp_only"``:
    every mesh axis is a data/FSDP axis (small models, where 16-way TP
    buys only per-layer activation all-reduces).  ``replicate_batch``:
    the decode layout, activations and inputs replicated over the batch
    axes so that the weight shards stay where they are; KV caches keep
    their batch sharding.  ``axis_sizes`` is read from the mesh and may
    be set afterwards (a test pretending a production mesh)."""
    mesh: Any
    fsdp_axis: str = "data"
    tp_axis: str = "model"
    layout: str = "default"
    replicate_batch: bool = False

    def __post_init__(self):
        names = tuple(self.mesh.mesh_dim_names)
        self.axis_sizes: Dict[str, int] = dict(zip(names,
                                                   tuple(self.mesh.shape)))
        if self.layout == "fsdp_only":
            all_batch = names                 # every axis is a batch axis
            self._fsdp_axes: Tuple[str, ...] = names
            self._tp_axes: Tuple[str, ...] = ()
        else:
            all_batch = tuple(a for a in ("pod", "data") if a in names)
            self._fsdp_axes = (self.fsdp_axis,) if self.fsdp_axis in names \
                else ()
            self._tp_axes = (self.tp_axis,) if self.tp_axis in names else ()
        self.cache_batch_axes: Tuple[str, ...] = all_batch
        self.batch_axes: Tuple[str, ...] = () if self.replicate_batch \
            else all_batch
        self.skipped: List[str] = []

    def _role_axis(self, role: Optional[str]):
        if role == "fsdp":
            return self._fsdp_axes or None
        if role == "tp":
            return self._tp_axes or None
        return None

    def _apply(self, roles: Tuple[Optional[str], ...],
               shape: Tuple[int, ...], path: str) -> Spec:
        n_lead = len(shape) - len(roles)
        spec: List[Any] = [None] * n_lead
        used = set()
        for dim, role in zip(shape[n_lead:], roles):
            axes = self._role_axis(role)
            if axes is not None:
                size = _prod(self.axis_sizes[a] for a in axes)
            if axes is not None and axes not in used and dim % size == 0:
                spec.append(axis_entry(axes))
                used.add(axes)
            else:
                if axes is not None:
                    self.skipped.append(
                        f"{path}: dim {dim} % {axes}({size}) != 0")
                spec.append(None)
        return tuple(spec)

    def param_pspec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        base = path.split(".")[-1]
        rules = _MOE_RULES + _PARAM_RULES if ".moe." in f".{path}." \
            else _PARAM_RULES
        for pat, roles in rules:
            if re.search(pat, base) and len(shape) >= len(roles):
                return self._apply(roles, shape, path)
        return ()

    def batch_pspec(self, shape: Tuple[int, ...]) -> Spec:
        """The leading (batch) dim over all batch axes, where it divides."""
        rest = (None,) * (len(shape) - 1)
        if self.batch_axes and shape and \
                shape[0] % _prod(self.axis_sizes[a]
                                 for a in self.batch_axes) == 0:
            return (axis_entry(self.batch_axes),) + rest
        return (None,) * len(shape)

    def input_pspec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        if name == "positions3":          # [3, B, S]
            return (None,) + self.batch_pspec(shape[1:])
        if name == "pos":
            return (None,)
        return self.batch_pspec(shape)

    def cache_pspec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        """Decode-state sharding: the batch dim, and a head or channel dim
        over tp."""
        base = path.split(".")[-1]
        if base in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
            # [..., B, T, Hkv, hd]; where the KV heads do not divide the
            # tp axis (GQA/MQA), the sequence dim is sharded instead
            n_lead = len(shape) - 4
            spec: List[Any] = [None] * n_lead
            spec.append(self._batch_axes_if(shape[n_lead]))
            head_ax = self._tp_if(shape[n_lead + 2])
            if head_ax is not None:
                spec.extend([None, head_ax, None])
            else:
                spec.extend([self._tp_if(shape[n_lead + 1]), None, None])
            return tuple(spec)
        if base == "enc_out":
            return (self._batch_axes_if(shape[0]), None, None)
        if base in ("h", "c", "n", "m", "S", "conv"):
            # recurrent state: [..., B, channels...]: batch, then tp on the
            # last dim
            n_lead = max(len(shape) - 2 if base != "S" else len(shape) - 4,
                         0)
            spec = [None] * n_lead
            if len(shape) > n_lead:
                spec.append(self._batch_axes_if(shape[n_lead]))
            rest = len(shape) - len(spec)
            for i in range(rest):
                if i == rest - 1 and base != "S":
                    spec.append(self._tp_if(shape[len(spec)]))
                else:
                    spec.append(None)
            return tuple(spec)
        return (None,) * len(shape)

    def _batch_axes_if(self, dim: int):
        axes = self.cache_batch_axes
        total = _prod(self.axis_sizes[a] for a in axes)
        return axis_entry(axes) if axes and total and dim % total == 0 \
            else None

    def _tp_if(self, dim: int):
        if not self._tp_axes:
            return None
        ax = self._tp_axes[0]
        return ax if dim % self.axis_sizes[ax] == 0 else None


def tree_pspecs(rules: ShardingRules, tree: Any, kind: str) -> Any:
    """The spec of every leaf of a (params | cache | inputs) tree of
    shapes (anything with ``.shape``), by its dotted path."""
    def per_leaf(path, leaf):
        p = ".".join(map(str, path))
        shape = tuple(leaf.shape)
        if kind == "params":
            return rules.param_pspec(p, shape)
        if kind == "cache":
            return rules.cache_pspec(p, shape)
        if kind == "inputs":
            return rules.input_pspec(p.split(".")[-1], shape)
        raise ValueError(kind)
    return _map(per_leaf, tree)


def to_placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim ``d``'s entry names it (a tuple of axes
    on one dim shards that dim on each of them, in mesh order), else
    ``Replicate()``; a mesh dim of one rank replicates (its one shard is
    the whole)."""
    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names mesh axis {name!r} twice")
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def tree_placements(rules: ShardingRules, tree: Any, kind: str) -> Any:
    """:func:`to_placements` of every leaf's :func:`tree_pspecs`."""
    return _map(lambda _, s: to_placements(s, rules.mesh),
                    tree_pspecs(rules, tree, kind))
