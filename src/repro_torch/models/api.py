"""Model API of the port (a port of :mod:`repro.models.api`'s
decoder-only half): recurrentgemma's hybrid, the dense decoders and the
mixture-of-experts decoders (whose parameter trees hold the experts
padded to ``cfg.n_experts_padded``, and whose ``forward`` returns the
layers' summed aux loss).  Encoder–decoder models raise
``NotImplementedError`` (ROADMAP A.6)."""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

Params = Dict[str, Any]


def _decoder_only(cfg: ArchConfig) -> None:
    if cfg.encdec:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet (ROADMAP A.6)")


def param_specs(cfg: ArchConfig) -> Params:
    _decoder_only(cfg)
    return transformer.param_specs(cfg)


def init_params(rng: Union[int, torch.Generator], cfg: ArchConfig,
                device: DeviceLike = "cuda") -> Params:
    """Random parameters drawn on ``device`` (the card by default)."""
    dev = resolve_device(device)
    _decoder_only(cfg)
    return transformer.init_params(rng, cfg, dev)


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, Any]):
    _decoder_only(cfg)
    return transformer.forward(params, cfg, batch)


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                batch: Dict[str, Any]):
    _decoder_only(cfg)
    return transformer.decode_step(params, cfg, cache, batch)


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> Params:
    _decoder_only(cfg)
    return transformer.cache_specs(cfg, batch, max_seq)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: DeviceLike = "cuda") -> Params:
    dev = resolve_device(device)
    _decoder_only(cfg)
    return transformer.init_cache(cfg, batch, max_seq, dev)
