"""AdamW with f32 moments, global-norm clipping and a cosine schedule (a
port of :mod:`repro.optim.adamw`).

Functional, as the reference: :func:`update` returns new parameters and
a new state and leaves its arguments as they were, so the caller holds
the old and the new moments together for the length of the call.  The
moments are f32 whatever the parameters' type; the bias corrections and
the learning rate are f32 scalars on the parameters' device; weight
decay applies where ``p.ndim >= 2``; each parameter is written back in
its own type.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.common.config import Config
from repro_torch.common.spec import TensorSpec
from repro_torch.common.tree import (map_with_paths, tree_field, tree_leaves,
                                     tree_map)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig(Config):
    lr_peak: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr_min_ratio: float = 0.1


class AdamWState(NamedTuple):
    count: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


def _device_of(params: Any) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def state_specs(param_specs: Any) -> AdamWState:
    """The state's shapes and types for a tree of parameter specs
    (:class:`~repro_torch.common.spec.TensorSpec`, nested dicts; nothing
    allocated): an int32 scalar count and f32 moments."""
    def moments():
        return map_with_paths(lambda _, s: TensorSpec(tuple(s.shape), F32),
                              param_specs, lambda x: not isinstance(x, dict))
    return AdamWState(count=TensorSpec((), torch.int32), mu=moments(),
                      nu=moments())


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine down to
    ``lr_min_ratio × lr_peak`` at ``total_steps``; f32 on ``step``'s
    device."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * cos
    return cfg.lr_peak * warm * frac


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf, in f32."""
    leaves = [torch.sum(torch.square(g.to(F32))) for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def update(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: returns (new params, new state, {"grad_norm",
    "lr"}), the metrics as 0-d f32 tensors."""
    count = state.count + 1
    lr = cosine_lr(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.betas
    countf = count.to(F32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=count.device),
                        countf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=count.device),
                        countf)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(F32)
        if p.ndim >= 2:
            step = step + cfg.weight_decay * pf
        return (pf - lr * step).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    return (tree_field(out, 0),
            AdamWState(count, tree_field(out, 1), tree_field(out, 2)),
            {"grad_norm": gnorm, "lr": lr})
