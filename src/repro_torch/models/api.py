"""Model API of the port (a port of :mod:`repro.models.api`'s model
half): dispatches the decoder-only models (:mod:`.transformer`:
recurrentgemma's hybrid, the dense, mixture-of-experts, xLSTM and
Qwen2-VL decoders) and the encoder–decoder (:mod:`.encdec`,
seamless-m4t) on ``cfg.encdec``.  A mixture-of-experts tree holds the
experts padded to ``cfg.n_experts_padded``, and its ``forward`` returns
the layers' summed aux loss."""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer

Params = Dict[str, Any]


def param_specs(cfg: ArchConfig) -> Params:
    return encdec.param_specs(cfg) if cfg.encdec else \
        transformer.param_specs(cfg)


def init_params(rng: Union[int, torch.Generator], cfg: ArchConfig,
                device: DeviceLike = "cuda") -> Params:
    """Random parameters drawn on ``device`` (the card by default), by
    :func:`transformer.init_params`' rules for either kind of model."""
    dev = resolve_device(device)
    if not cfg.encdec:
        return transformer.init_params(rng, cfg, dev)
    return transformer.draw_params(rng, encdec.param_specs(cfg), dev)


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, Any]):
    if cfg.encdec:
        return encdec.forward(params, cfg, batch)
    return transformer.forward(params, cfg, batch)


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                batch: Dict[str, Any]):
    if cfg.encdec:
        return encdec.decode_step(params, cfg, cache, batch)
    return transformer.decode_step(params, cfg, cache, batch)


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> Params:
    if cfg.encdec:
        # the source side sees the same budget; decode grows up to max_seq
        return encdec.cache_specs(cfg, batch, src_len=max_seq,
                                  max_tgt=max_seq)
    return transformer.cache_specs(cfg, batch, max_seq)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: DeviceLike = "cuda") -> Params:
    """Zeros over :func:`cache_specs` on ``device``, for either kind of
    model."""
    dev = resolve_device(device)
    return transformer.map_tree(
        lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
        cache_specs(cfg, batch, max_seq))
