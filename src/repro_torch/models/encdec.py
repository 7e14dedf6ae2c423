"""Encoder–decoder transformer of the port, seamless-m4t's backbone (a
port of :mod:`repro.models.encdec`).

The audio frontend is a stub: ``src_embeds`` are precomputed frame
embeddings.  The encoder is a bidirectional self-attention stack (RoPE
on queries and keys, then ``enc_norm``); a decoder layer is causal
self-attention, cross-attention on the encoder's output without RoPE,
then the gated MLP.  The unembedding is tied to ``embed``, in f32.
Where the reference scans over the stacked layers, the port loops over
them (each stacked leaf split once, :func:`~.transformer.unstack`), and
where it rematerialises each layer (``jax.checkpoint``), the port keeps
the activations: the encoder–decoder is not on the card's training path.
:func:`lm_loss` is the mean next-token cross entropy.

Attention runs the port's CUDA kernel on the card: the encoder's and the
cross-attention's calls are :func:`repro_torch.kernels.flash_attention
.flash_attention` with ``causal=False`` (the cross-attention's queries
and keys of other lengths), the decoder's self-attention with
``causal=True``.  Decoding goes through
:func:`~repro_torch.models.layers.decode_attention`, as the reference's
does: the self cache's slot is ``pos % Tmax``, the cross cache is the
source's whole length.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.act_shard import gather_weights
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_norm, apply_rope,
                                       decode_attention, einsum, heads_out)
from repro_torch.models.transformer import (TensorSpec, _dtype, _ffn,
                                            _mlp_specs, _project_qkv, _stack,
                                            embed_tokens, gold_logits, take,
                                            unembed, unstack)

Params = Dict[str, Any]


def _attn_proj_specs(cfg: ArchConfig, prefix: str) -> Dict[str, TensorSpec]:
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dtype(cfg)
    return {f"{prefix}wq": TensorSpec((D, Hq, hd), dt),
            f"{prefix}wk": TensorSpec((D, Hkv, hd), dt),
            f"{prefix}wv": TensorSpec((D, Hkv, hd), dt),
            f"{prefix}wo": TensorSpec((Hq, hd, D), dt)}


def _enc_layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    dt = _dtype(cfg)
    s: Dict[str, Any] = _attn_proj_specs(cfg, "")
    s["mlp"] = _mlp_specs(cfg)
    s["ln1"] = TensorSpec((cfg.d_model,), dt)
    s["ln2"] = TensorSpec((cfg.d_model,), dt)
    return s


def _dec_layer_specs(cfg: ArchConfig) -> Dict[str, Any]:
    dt = _dtype(cfg)
    s: Dict[str, Any] = _attn_proj_specs(cfg, "")
    s.update(_attn_proj_specs(cfg, "x_"))
    s["mlp"] = _mlp_specs(cfg)
    for k in ("ln1", "ln_x", "ln2"):
        s[k] = TensorSpec((cfg.d_model,), dt)
    return s


def param_specs(cfg: ArchConfig) -> Params:
    dt = _dtype(cfg)
    return {
        "embed": TensorSpec((cfg.vocab, cfg.d_model), dt),
        "enc": _stack(_enc_layer_specs(cfg), cfg.n_enc_layers),
        "dec": _stack(_dec_layer_specs(cfg), cfg.n_dec_layers),
        "enc_norm": TensorSpec((cfg.d_model,), dt),
        "final_norm": TensorSpec((cfg.d_model,), dt),
    }


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None]


def encode(params: Params, cfg: ArchConfig,
           src_embeds: torch.Tensor) -> torch.Tensor:
    """src_embeds [B,Ss,D] → the encoder's output [B,Ss,D] in the
    parameters' type (moved to their device)."""
    x = src_embeds.to(params["embed"].device, _dtype(cfg))
    pos = _positions(x.shape[1], x.device)
    for p in unstack(params["enc"], cfg.n_enc_layers):
        p = gather_weights(p)
        h = apply_norm(cfg.norm_kind, x, p["ln1"])
        q, k, v = _project_qkv(p, h)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        att = flash_attention(q, k, v, causal=False)
        x = x + heads_out(att, p["wo"])
        x = _ffn(cfg, p, x)[0]
    return apply_norm(cfg.norm_kind, x, params["enc_norm"])


def _dec_layer(cfg: ArchConfig, p: Params, x: torch.Tensor,
               enc_out: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg.norm_kind, x, p["ln1"])
    q, k, v = _project_qkv(p, h)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    att = flash_attention(q, k, v, causal=True)
    x = x + heads_out(att, p["wo"])

    hx = apply_norm(cfg.norm_kind, x, p["ln_x"])
    qx = einsum("bsd,dhe->bshe", hx, p["x_wq"])
    kx = einsum("bsd,dhe->bshe", enc_out, p["x_wk"])
    vx = einsum("bsd,dhe->bshe", enc_out, p["x_wv"])
    attx = flash_attention(qx, kx, vx, causal=False)
    x = x + heads_out(attx, p["x_wo"])
    return _ffn(cfg, p, x)[0]


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: src_embeds [B,Ss,D], tokens [B,St] → (logits [B,St,V] f32,
    a zero aux loss)."""
    enc_out = encode(params, cfg, batch["src_embeds"])
    x = embed_tokens(params, cfg, batch["tokens"])
    pos = _positions(x.shape[1], x.device)
    for p in unstack(params["dec"], cfg.n_dec_layers):
        x = _dec_layer(cfg, gather_weights(p), x, enc_out, pos)
    return (unembed(params, cfg, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def lm_loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The mean cross entropy of each target token after the first given
    the ones before it.  Returns (loss, {"loss", "aux"})."""
    logits, aux = forward(params, cfg, batch)
    lb = batch["tokens"].to(logits.device).long()[:, 1:]
    lg = logits[:, :-1]
    logz = torch.logsumexp(lg, dim=-1)
    gold = gold_logits(lg, lb)
    loss = torch.mean(logz - gold)
    return loss, {"loss": loss, "aux": aux}


# -- decoding ----------------------------------------------------------------

def cache_specs(cfg: ArchConfig, batch: int, src_len: int,
                max_tgt: int) -> Params:
    dt = _dtype(cfg)
    Hkv, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_dec_layers
    return {
        "enc_out": TensorSpec((batch, src_len, cfg.d_model), dt),
        "self_k": TensorSpec((L, batch, max_tgt, Hkv, hd), dt),
        "self_v": TensorSpec((L, batch, max_tgt, Hkv, hd), dt),
        "cross_k": TensorSpec((L, batch, src_len, Hkv, hd), dt),
        "cross_v": TensorSpec((L, batch, src_len, Hkv, hd), dt),
    }


def init_cache_from_encoder(params: Params, cfg: ArchConfig,
                            src_embeds: torch.Tensor,
                            max_tgt: int) -> Params:
    """Encode the source and project it once through every decoder
    layer's stacked ``x_wk``/``x_wv`` (one product each); the self caches
    are zeros of ``max_tgt`` positions."""
    enc_out = encode(params, cfg, src_embeds)
    B = enc_out.shape[0]
    dt = _dtype(cfg)
    kx = einsum("bsd,ldhe->lbshe", enc_out, params["dec"]["x_wk"])
    vx = einsum("bsd,ldhe->lbshe", enc_out, params["dec"]["x_wv"])
    shape = (cfg.n_dec_layers, B, max_tgt, cfg.n_kv_heads, cfg.head_dim)
    return {"enc_out": enc_out,
            "self_k": torch.zeros(shape, dtype=dt, device=enc_out.device),
            "self_v": torch.zeros(shape, dtype=dt, device=enc_out.device),
            "cross_k": kx.to(dt), "cross_v": vx.to(dt)}


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                batch: Dict[str, Any]) -> Tuple[torch.Tensor, Params]:
    """tokens [B,1], pos (an int or a one-element tensor) → (logits
    [B,1,V], new cache); the old cache is left as it was."""
    x = embed_tokens(params, cfg, batch["tokens"])
    pos = batch["pos"]
    pos = int(pos.reshape(-1)[0]) if isinstance(pos, torch.Tensor) \
        else int(pos)
    B, dev = x.shape[0], x.device
    Tmax = cache["self_k"].shape[2]
    cache_len = torch.full((B,), min(pos + 1, Tmax), dtype=torch.int32,
                           device=dev)
    src_len = torch.full((B,), cache["cross_k"].shape[2], dtype=torch.int32,
                         device=dev)
    pos_t = torch.full((1, 1), pos, dtype=torch.int32, device=dev)
    slot = pos % Tmax
    new_k, new_v = [], []
    for j in range(cfg.n_dec_layers):
        p = take(params["dec"], j)
        h = apply_norm(cfg.norm_kind, x, p["ln1"])
        q, k, v = _project_qkv(p, h)
        q = apply_rope(q, pos_t, cfg.rope_theta)
        k = apply_rope(k, pos_t, cfg.rope_theta)
        sk, sv = cache["self_k"][j].clone(), cache["self_v"][j].clone()
        sk[:, slot] = k[:, 0].to(sk.dtype)
        sv[:, slot] = v[:, 0].to(sv.dtype)
        att = decode_attention(q, sk, sv, cache_len)
        x = x + heads_out(att, p["wo"])
        hx = apply_norm(cfg.norm_kind, x, p["ln_x"])
        qx = einsum("bsd,dhe->bshe", hx, p["x_wq"])
        attx = decode_attention(qx, cache["cross_k"][j], cache["cross_v"][j],
                                src_len)
        x = x + heads_out(attx, p["x_wo"])
        x = _ffn(cfg, p, x)[0]
        new_k.append(sk)
        new_v.append(sv)
    cache = dict(cache, self_k=torch.stack(new_k), self_v=torch.stack(new_v))
    return unembed(params, cfg, x), cache
