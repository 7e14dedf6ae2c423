"""Train, eval and serve step factories (a port of
:mod:`repro.train.step`), in eager PyTorch.

``make_train_step`` builds the full step: loss → gradients (autograd)
→ optional micro-batch accumulation, with int8 error-feedback
compression → AdamW update.  Microbatches run as a Python loop with f32
accumulators where the reference scans.  :class:`TrainConfig` has no
``use_pallas``: as in serving, the tensors' device chooses the route (the
CUDA kernels, their backward kernels included, on the card; their plain
versions on the CPU).  Its ``aux_weight`` is, as in the reference, never
read: :func:`repro_torch.models.api.loss_fn` takes the loss's default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.common.config import Config
from repro_torch.common.tree import (leaves_with_paths, map_with_paths,
                                     tree_map)
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.optim import adamw, compress

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig(Config):
    microbatches: int = 1
    remat: bool = True
    # "full": save nothing inside a period (least memory); "dots": save
    # the matrix products' outputs (no recompute of them in the backward)
    remat_policy: str = "full"
    compress_grads: bool = False
    aux_weight: float = 0.01
    optim: adamw.AdamWConfig = adamw.AdamWConfig()


def _split_microbatch(batch: Dict[str, torch.Tensor], n: int, i: int
                      ) -> Dict[str, torch.Tensor]:
    """Microbatch ``i`` of ``n``: rows on axis 0, ``positions3`` on axis 1,
    ``pos`` whole."""
    out = {}
    for k, v in batch.items():
        if k == "pos":
            out[k] = v
            continue
        axis = 1 if k == "positions3" else 0
        size = v.shape[axis] // n
        out[k] = v.narrow(axis, i * size, size)
    return out


def value_and_grad(cfg: ArchConfig, tcfg: TrainConfig, params: Any,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(total loss, metrics, gradients in the parameters' types and tree);
    a parameter the loss does not reach gets a zero gradient, as
    ``jax.grad`` gives it."""
    paths = [p for p, _ in leaves_with_paths(params)]
    leaves = {}

    def track(path, p):
        leaves[path] = p.detach().requires_grad_(True)
        return leaves[path]
    live = map_with_paths(track, params)
    with torch.enable_grad():
        total, metrics = api.loss_fn(live, cfg, batch, remat=tcfg.remat,
                                     remat_policy=tcfg.remat_policy)
        grads = torch.autograd.grad(total, [leaves[p] for p in paths],
                                    allow_unused=True)
    by_path = {p: (g if g is not None else torch.zeros_like(leaves[p]))
               for p, g in zip(paths, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, map_with_paths(
        lambda path, _: by_path[path], params)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; metrics ``loss``, ``aux``, ``grad_norm``,
    ``lr`` and ``total`` are 0-d tensors on the parameters' device."""

    def train_step(params, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor]):
        n = tcfg.microbatches
        if n <= 1:
            loss, metrics, grads = value_and_grad(cfg, tcfg, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                   device=p.device), params)
            err = (compress.init_error_tree(params) if tcfg.compress_grads
                   else None)
            losses, plain, auxes = [], [], []
            for i in range(n):
                mb = _split_microbatch(batch, n, i)
                loss_i, m_i, g_i = value_and_grad(cfg, tcfg, params, mb)
                if tcfg.compress_grads:
                    g_i, err = compress.tree_quantize_with_feedback(g_i, err)
                grads = tree_map(lambda a, g: a + g.to(F32) / n, grads, g_i)
                losses.append(loss_i)
                plain.append(m_i["loss"])
                auxes.append(m_i["aux"])
            loss = torch.stack(losses).mean()
            metrics = {"loss": torch.stack(plain).mean(),
                       "aux": torch.stack(auxes).mean()}
        params, opt_state, opt_metrics = adamw.update(
            tcfg.optim, grads, opt_state, params)
        metrics = dict(metrics, **opt_metrics, total=loss)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = api.loss_fn(params, cfg, batch, remat=False)
        return metrics
    return eval_step


def make_prefill_step(cfg: ArchConfig, max_seq: int) -> Callable:
    from repro_torch.models import encdec, transformer

    def prefill_step(params, batch):
        with torch.no_grad():
            if cfg.encdec:
                return encdec.init_cache_from_encoder(
                    params, cfg, batch["src_embeds"], max_tgt=max_seq)
            return transformer.prefill(params, cfg, batch, max_seq=max_seq)
    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, cache, batch):
        with torch.no_grad():
            return api.decode_step(params, cfg, cache, batch)
    return serve_step
