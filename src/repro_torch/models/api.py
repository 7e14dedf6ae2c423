"""Model API of the port (a port of :mod:`repro.models.api`): dispatches the decoder-only models (:mod:`.transformer`:
recurrentgemma's hybrid, the dense, mixture-of-experts, xLSTM and
Qwen2-VL decoders) and the encoder–decoder (:mod:`.encdec`,
seamless-m4t) on ``cfg.encdec``.  A mixture-of-experts tree holds the
experts padded to ``cfg.n_experts_padded``, and its ``forward`` returns
the layers' summed aux loss.  :func:`loss_fn` is the training objective,
:func:`input_specs` and :func:`concrete_inputs` the inputs of a shape
cell."""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import encdec, transformer
from repro_torch.models.transformer import TensorSpec

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


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
            remat: bool = True, remat_policy: str = "full"):
    """(total loss, {"loss", "aux"}).  As in the reference, the
    decoder-only loss takes its default ``aux_weight`` (0.01): nothing
    passes another."""
    if cfg.encdec:
        return encdec.lm_loss(params, cfg, batch)
    return transformer.lm_loss(params, cfg, batch, remat,
                               remat_policy=remat_policy)


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, Any], **kw):
    if cfg.encdec:
        return encdec.forward(params, cfg, batch)
    return transformer.forward(params, cfg, batch, **kw)


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
    if not cfg.encdec:
        return transformer.init_cache(cfg, batch, max_seq, device)
    dev = resolve_device(device)
    return transformer.map_tree(
        lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
        cache_specs(cfg, batch, max_seq))


# ---------------------------------------------------------------------------
# Inputs of a shape cell
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeCell) -> Dict[str, TensorSpec]:
    """Shapes and types of every model input of the cell (nothing
    allocated)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = transformer.DTYPES[cfg.param_dtype]
    if shape.mode in ("train", "prefill"):
        if cfg.encdec:
            return {"src_embeds": TensorSpec((B, S, cfg.d_model), dt),
                    "tokens": TensorSpec((B, S), i32)}
        if cfg.input_mode == "embeds":
            batch = {"embeds": TensorSpec((B, S, cfg.d_model), dt),
                     "labels": TensorSpec((B, S), i32)}
            if cfg.mrope:
                batch["positions3"] = TensorSpec((3, B, S), i32)
            return batch
        return {"tokens": TensorSpec((B, S), i32)}
    # decode: one new token against a seq_len-deep cache
    if cfg.encdec:
        return {"tokens": TensorSpec((B, 1), i32),
                "pos": TensorSpec((1,), i32)}
    if cfg.input_mode == "embeds":
        batch = {"embeds": TensorSpec((B, 1, cfg.d_model), dt),
                 "pos": TensorSpec((1,), i32)}
        if cfg.mrope:
            batch["positions3"] = TensorSpec((3, B, 1), i32)
        return batch
    return {"tokens": TensorSpec((B, 1), i32), "pos": TensorSpec((1,), i32)}


def concrete_inputs(gen: torch.Generator, cfg: ArchConfig, shape: ShapeCell,
                    device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Random inputs matching :func:`input_specs`, drawn on ``device``
    from ``gen`` (a generator on that device) in the specs' key order:
    token ids and labels in [0, vocab), other ints in [0, max(seq_len,
    2)), floats standard normal; ``pos`` is ``[seq_len - 1]``."""
    dev = resolve_device(device)
    out = {}
    for k, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            hi = cfg.vocab if k in ("tokens", "labels") \
                else max(shape.seq_len, 2)
            out[k] = torch.randint(0, hi, s.shape, generator=gen,
                                   device=dev, dtype=torch.int32)
        else:
            out[k] = torch.randn(s.shape, generator=gen, device=dev,
                                 dtype=torch.float32).to(s.dtype)
    if "pos" in out:
        out["pos"] = torch.tensor([shape.seq_len - 1], dtype=torch.int32,
                                  device=dev)
    return out
