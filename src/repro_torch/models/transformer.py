"""Decoder-only LM of the port: every block kind of the reference —
``attn``, ``attn_local`` and ``attn_global`` with a dense MLP or a
mixture of experts after attention, ``rglru``, ``mlstm`` and ``slstm``
(a port of :mod:`repro.models.transformer`).

Parameters are a nested dict of tensors in the reference's layout:
layers grouped into pattern periods with each leaf stacked over periods
(``params["blocks"]["p{i}_{kind}"]``), a remainder group
(``params["rem"]["r{i}_{kind}"]``, recurrentgemma's 38 = 12·3 + 2), the
tied embedding and the final norm.  An attention block of a ``moe``
family config holds a ``moe`` subtree (router [D, E], experts padded to
``cfg.n_experts_padded``, shared experts where ``n_shared_experts`` > 0)
in place of ``mlp``.  Where the reference scans over periods, the port
loops over them.

Four entry points:
  * :func:`forward`      — full-sequence logits (+ the MoE aux loss)
  * :func:`lm_loss`      — next-token cross entropy (+ the aux loss):
                            the train path
  * :func:`prefill`      — forward that also fills the decode cache
  * :func:`decode_step`  — one token against the cache: the serve path

In training (grad mode on, parameters requiring grad) :func:`forward`
rematerialises each period of
``block_pattern`` as the reference's ``jax.checkpoint(period_body)``
does (``torch.utils.checkpoint``, non-reentrant): ``remat_policy="full"``
saves nothing inside a period, ``"dots"`` saves the matrix products'
outputs (a selective-checkpoint policy, the counterpart of
``dots_with_no_batch_dims_saveable``); the remainder layers are not
checkpointed, as in the reference.  A stacked leaf is split into its
periods once a forward (``torch.unbind``), so its gradient is one stack
of the periods' gradients.

The two sequence mixers run the port's CUDA kernels on the card:
attention through :func:`repro_torch.kernels.flash_attention
.flash_attention` where the reference calls ``blocked_attention``, the
RG-LRU recurrence through :func:`repro_torch.kernels.rglru_scan
.rglru_scan` where it calls ``rglru_scan_ref``.  The reference's
``use_pallas`` flag has no counterpart: the tensors' device chooses.
The MoE layer (:mod:`.moe`) and the mLSTM/sLSTM blocks
(:mod:`.recurrent`) are plain PyTorch, as the reference's are plain
``jnp``.  An ``embeds`` config (qwen2-vl) takes ``batch["embeds"]``, cast
to the parameters' type and not scaled; with ``cfg.mrope`` and
``batch["positions3"]`` its attention rotates by M-RoPE, otherwise by
RoPE, as the reference's does.

Under the dry run's activation-sharding context
(:mod:`repro_torch.distributed.act_shard`) the residual stream, the
projections, the MLP hidden and the logits are pinned to the reference's
layouts (``constrain``, at the reference's places), and each period's
FSDP-sharded weights are gathered once at the top of its body
(``gather_weights``; recomputed with the period in the backward, where
its gradients are reduce-scattered); without a context both return
their arguments.

Types follow the reference op by op (see :mod:`.layers`).  A float32
product is full float32 only with TF32 off: the port leaves
``torch.backends.cuda.matmul.allow_tf32`` (False by default) and
``torch.backends.cudnn.allow_tf32`` as the caller set them, and
``chip_smoke.py`` sets both False.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.common.spec import TensorSpec
from repro_torch.common.tree import leaves_with_paths, map_with_paths
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.act_shard import (constrain, gather_weights,
                                               lookup_table, settle)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (apply_mrope, apply_norm, apply_rope,
                                       decode_attention, einsum, einsum_f32,
                                       gated_mlp, heads_out, log_sigmoid)
from repro_torch.models.moe import moe_ffn

Params = Dict[str, Any]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
ATTN_KINDS = ("attn", "attn_local", "attn_global")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def _norm_has_scale(cfg: ArchConfig) -> bool:
    return cfg.norm_kind in ("rmsnorm", "layernorm")


def _unknown(kind: str) -> ValueError:
    return ValueError(f"unknown block kind {kind}")


# ---------------------------------------------------------------------------
# Parameter specs and initialisation
# ---------------------------------------------------------------------------

def _mlp_specs(cfg: ArchConfig) -> Dict[str, TensorSpec]:
    D, F, dt = cfg.d_model, cfg.d_ff, _dtype(cfg)
    return {"w_gate": TensorSpec((D, F), dt), "w_up": TensorSpec((D, F), dt),
            "w_down": TensorSpec((F, D), dt)}


def _moe_specs(cfg: ArchConfig) -> Dict[str, TensorSpec]:
    D, E, dt = cfg.d_model, cfg.n_experts, _dtype(cfg)
    Fm = cfg.moe_d_ff or cfg.d_ff
    Ep = cfg.n_experts_padded          # the padding experts get no tokens
    s = {"router": TensorSpec((D, E), dt),
         "w_gate": TensorSpec((Ep, D, Fm), dt),
         "w_up": TensorSpec((Ep, D, Fm), dt),
         "w_down": TensorSpec((Ep, Fm, D), dt)}
    if cfg.n_shared_experts > 0:
        Fs = Fm * cfg.n_shared_experts
        s.update(shared_gate=TensorSpec((D, Fs), dt),
                 shared_up=TensorSpec((D, Fs), dt),
                 shared_down=TensorSpec((Fs, D), dt))
    return s


def _attn_specs(cfg: ArchConfig) -> Dict[str, Any]:
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = _dtype(cfg)
    s: Dict[str, Any] = {
        "wq": TensorSpec((D, Hq, hd), dt),
        "wk": TensorSpec((D, Hkv, hd), dt),
        "wv": TensorSpec((D, Hkv, hd), dt),
        "wo": TensorSpec((Hq, hd, D), dt),
    }
    if _norm_has_scale(cfg):
        s["ln1"] = TensorSpec((D,), dt)
        s["ln2"] = TensorSpec((D,), dt)
    if cfg.family == "moe":
        s["moe"] = _moe_specs(cfg)
    elif cfg.d_ff > 0:
        s["mlp"] = _mlp_specs(cfg)
    return s


def _rglru_specs(cfg: ArchConfig) -> Dict[str, Any]:
    D, Dr, K = cfg.d_model, cfg.d_rec_actual, cfg.conv_width
    dt = _dtype(cfg)
    s: Dict[str, Any] = {
        "w_gate": TensorSpec((D, Dr), dt),
        "w_rec": TensorSpec((D, Dr), dt),
        "conv": TensorSpec((K, Dr), dt),
        "w_a": TensorSpec((Dr, Dr), dt),
        "w_x": TensorSpec((Dr, Dr), dt),
        "lam": TensorSpec((Dr,), torch.float32),
        "w_out": TensorSpec((Dr, D), dt),
    }
    if _norm_has_scale(cfg):
        s["ln1"] = TensorSpec((D,), dt)
        s["ln2"] = TensorSpec((D,), dt)
    if cfg.d_ff > 0:
        s["mlp"] = _mlp_specs(cfg)
    return s


def _mlstm_specs(cfg: ArchConfig) -> Dict[str, Any]:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    dt = _dtype(cfg)
    s: Dict[str, Any] = {
        "wq": TensorSpec((D, H, hd), dt),
        "wk": TensorSpec((D, H, hd), dt),
        "wv": TensorSpec((D, H, hd), dt),
        "w_if": TensorSpec((D, 2 * H), torch.float32),
        "w_og": TensorSpec((D, D), dt),
        "w_out": TensorSpec((H, hd, D), dt),
    }
    if _norm_has_scale(cfg):
        s["ln1"] = TensorSpec((D,), dt)
    return s


def _slstm_specs(cfg: ArchConfig) -> Dict[str, Any]:
    D = cfg.d_model
    # the recurrent weights stay f32 whatever param_dtype is
    s: Dict[str, Any] = {k: TensorSpec((D, D), torch.float32)
                         for k in ("w_z", "w_i", "w_f", "w_o",
                                   "r_z", "r_i", "r_f", "r_o")}
    if _norm_has_scale(cfg):
        s["ln1"] = TensorSpec((D,), _dtype(cfg))
    return s


def _block_specs(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    if kind in ATTN_KINDS:
        return _attn_specs(cfg)
    if kind == "rglru":
        return _rglru_specs(cfg)
    if kind == "mlstm":
        return _mlstm_specs(cfg)
    if kind == "slstm":
        return _slstm_specs(cfg)
    raise _unknown(kind)


def _not_dict(x) -> bool:
    return not isinstance(x, dict)


def map_tree(fn, tree):
    """``fn(path, leaf)`` over a nested dict, keys in sorted order; a
    :class:`TensorSpec` or a tuple is a leaf."""
    return map_with_paths(fn, tree, _not_dict)


def leaves(tree):
    """(path, leaf) pairs of a nested dict, keys in sorted order (JAX's
    flattening order)."""
    return leaves_with_paths(tree, _not_dict)


def _stack(specs: Dict[str, Any], n: int) -> Dict[str, Any]:
    return map_tree(lambda _, s: TensorSpec((n,) + s.shape, s.dtype), specs)


def group_layout(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_full_periods, n_remainder_layers)."""
    per = len(cfg.block_pattern)
    return cfg.n_layers // per, cfg.n_layers % per


def param_specs(cfg: ArchConfig) -> Params:
    dt = _dtype(cfg)
    n_per, n_rem = group_layout(cfg)
    specs: Params = {"embed": TensorSpec((cfg.vocab, cfg.d_model), dt)}
    specs["blocks"] = {f"p{i}_{kind}": _stack(_block_specs(cfg, kind), n_per)
                       for i, kind in enumerate(cfg.block_pattern)}
    if n_rem:
        specs["rem"] = {f"r{i}_{cfg.block_pattern[i]}": _block_specs(
            cfg, cfg.block_pattern[i]) for i in range(n_rem)}
    if _norm_has_scale(cfg):
        specs["final_norm"] = TensorSpec((cfg.d_model,), dt)
    if not cfg.tie_embeddings:
        specs["lm_head"] = TensorSpec((cfg.d_model, cfg.vocab), dt)
    return specs


def param_count(cfg: ArchConfig) -> int:
    return sum(math.prod(s.shape) for _, s in leaves(param_specs(cfg)))


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters a token uses: a routed expert leaf counts top_k of its
    n_experts_padded experts, the shared experts in full, the embedding
    and lm_head not at all (the 6·N·D convention)."""
    total = 0
    for path, s in leaves(param_specs(cfg)):
        name = "/".join(path)
        if "embed" in name or "lm_head" in name:
            continue
        n = math.prod(s.shape)
        if "moe" in path and path[-1] in ("w_gate", "w_up", "w_down"):
            n = n * cfg.top_k // max(cfg.n_experts_padded, 1)
        total += n
    return total


def init_params(rng: Union[int, torch.Generator], cfg: ArchConfig,
                device: DeviceLike = "cuda") -> Params:
    """Random initialisation by the reference's rules, drawn on ``device``
    from ``rng`` (a seed, or a :class:`torch.Generator` on that device).
    The draws are the port's own: to compute what a reference tree
    computes, carry it across with :func:`repro_torch.convert.lm_params`."""
    return draw_params(rng, param_specs(cfg), resolve_device(device))


def draw_params(rng: Union[int, torch.Generator], specs: Params,
                dev: torch.device) -> Params:
    """A tree of ``specs``' shapes and types drawn on ``dev`` from ``rng``
    leaf by leaf in key order, each by :func:`_init_leaf`'s rule for its
    path (the reference's ``_init_leaf``, which its encoder–decoder's
    ``init_params`` shares)."""
    if isinstance(rng, torch.Generator):
        gen = rng
        if gen.device.type != dev.type:
            raise ValueError(f"init_params: generator on {gen.device}, "
                             f"parameters on {dev}")
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng))
    return map_tree(lambda path, s: _init_leaf(gen, "/".join(path), s, dev),
                specs)


def _init_leaf(gen: torch.Generator, name: str, s: TensorSpec,
               dev: torch.device) -> torch.Tensor:
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    if name.endswith("lam"):
        # RG-LRU: a = exp(-c softplus(lam)) in (0.9, 0.999) at r = 0.5
        a = torch.rand(s.shape, **f32) * (0.999 - 0.9) + 0.9
        sp = -torch.log(a) / rec.RGLRU_C * 2.0
        return torch.log(torch.expm1(torch.clamp_min(sp, 1e-6)))
    if "ln" in name.split("/")[-1] or name.endswith("final_norm"):
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)
    if name.endswith("conv"):
        return (torch.randn(s.shape, **f32) * 0.1).to(s.dtype)
    shape = s.shape
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if len(shape) >= 3:
        fan_in = math.prod(shape[:-1]) // (shape[0] if len(shape) == 4
                                           else 1)
        fan_in = max(fan_in, 1)
    std = 0.02 if "embed" in name else 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.randn(shape, **f32)
    out.mul_(std)
    return out.to(s.dtype)


# ---------------------------------------------------------------------------
# Block applications (forward / prefill path)
# ---------------------------------------------------------------------------

def _window_for(cfg: ArchConfig, kind: str) -> int:
    if kind in ("attn_local", "attn"):
        return cfg.sliding_window
    return 0


def _project_qkv(p: Params, h: torch.Tensor):
    return tuple(constrain(einsum("bsd,dhe->bshe", h, p[w]), "bshe")
                 for w in ("wq", "wk", "wv"))


def _ffn(cfg: ArchConfig, p: Params, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the residual stream: the mixture of experts
    where the block has ``moe``, else the dense MLP where it has ``mlp``.
    Returns (x_out, the MoE aux loss or None)."""
    if "moe" not in p and "mlp" not in p:
        return x, None
    h2 = apply_norm(cfg.norm_kind, x, p.get("ln2"))
    if "moe" in p:
        y, aux = moe_ffn(h2, p["moe"], n_experts=cfg.n_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, act=cfg.act)
        return x + y, aux
    m = p["mlp"]
    return x + gated_mlp(h2, m["w_gate"], m["w_up"], m["w_down"],
                         act=cfg.act), None


def _rotate(cfg: ArchConfig, x: torch.Tensor, pos: torch.Tensor,
            pos3: Optional[torch.Tensor]) -> torch.Tensor:
    """M-RoPE where the config asks for it and 3-axis positions are
    given, else RoPE (the reference's fallback)."""
    if cfg.mrope and pos3 is not None:
        return apply_mrope(x, pos3, theta=cfg.rope_theta)
    return apply_rope(x, pos, theta=cfg.rope_theta)


def _apply_attn_block(cfg: ArchConfig, kind: str, p: Params,
                      x: torch.Tensor, pos: torch.Tensor,
                      pos3: Optional[torch.Tensor]):
    """Returns (x_out, aux loss or None, (k, v)); k/v exposed for prefill
    caching."""
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    q, k, v = _project_qkv(p, h)
    q = _rotate(cfg, q, pos, pos3)
    k = _rotate(cfg, k, pos, pos3)
    att = flash_attention(q, k, v, causal=True,
                          window=_window_for(cfg, kind),
                          softcap=cfg.attn_softcap)
    x = constrain(x + heads_out(att, p["wo"]), "bsd")
    x, aux = _ffn(cfg, p, x)
    return x, aux, (k, v)


def _rglru_mix(cfg: ArchConfig, p: Params, x: torch.Tensor):
    """The recurrent branch of an rglru block on x: returns x + y, the
    recurrence's states h [B,S,Dr] and the pre-conv input r."""
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    gate = rec.activation(einsum("bsd,de->bse", h, p["w_gate"]), "gelu")
    r = einsum("bsd,de->bse", h, p["w_rec"])
    a, u = rec.rglru_gates(rec.causal_conv1d(r, p["conv"]), p)
    hs = rec.rglru_scan_ref(a, u)
    y = einsum("bse,ed->bsd", hs * gate, p["w_out"])
    return x + y.to(x.dtype), hs, r


def _apply_rglru_block(cfg: ArchConfig, p: Params,
                       x: torch.Tensor) -> torch.Tensor:
    x, _, _ = _rglru_mix(cfg, p, x)
    return _ffn(cfg, p, x)[0]


def _mlstm_inputs(p: Params, h: torch.Tensor):
    """q, k, v [B,S,H,hd] and the f32 log forget and input gates [B,S,H]
    of an mLSTM block on its normed input h [B,S,D]."""
    q, k, v = _project_qkv(p, h)
    gates = einsum("bsd,dg->bsg", h.float(), p["w_if"])
    log_i, log_f = gates.chunk(2, dim=-1)
    return q, k, v, log_sigmoid(log_f), log_i


def _apply_mlstm_block(cfg: ArchConfig, p: Params,
                       x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    q, k, v, log_f, log_i = _mlstm_inputs(p, h)
    y = rec.mlstm_parallel(q, k, v, log_f, log_i, chunk=cfg.mlstm_chunk)
    og = torch.sigmoid(einsum("bsd,de->bse", h, p["w_og"]))
    out = heads_out(y, p["w_out"])
    return x + (out * og).to(x.dtype)


def _apply_slstm_block(cfg: ArchConfig, p: Params, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, rec.SLSTMState]:
    """(x_out, the recurrence's final state)."""
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    y, state = rec.slstm_seq(h, p)
    return x + y.to(x.dtype), state


def apply_block(cfg: ArchConfig, kind: str, p: Params, x: torch.Tensor,
                pos: torch.Tensor, pos3: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x_out, the block's MoE aux loss or None)."""
    if kind in ATTN_KINDS:
        return _apply_attn_block(cfg, kind, p, x, pos, pos3)[:2]
    if kind == "rglru":
        return _apply_rglru_block(cfg, p, x), None
    if kind == "mlstm":
        return _apply_mlstm_block(cfg, p, x), None
    if kind == "slstm":
        return _apply_slstm_block(cfg, p, x)[0], None
    raise _unknown(kind)


def take(tree: Params, j: int) -> Params:
    """Period ``j`` of a tree stacked over periods."""
    return map_tree(lambda _, x: x[j], tree)


def unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` periods of a tree stacked over periods, each leaf split
    once by ``torch.unbind`` (views; its backward stacks the periods'
    gradients into one tensor, where indexing a period at a time would
    make a full-size gradient for each)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][j] for k in tree} for j in range(n)]
    return list(torch.unbind(tree, 0))


def _layers(cfg: ArchConfig, params: Params):
    """(cache key group, key, kind, block params) in layer order."""
    n_per, n_rem = group_layout(cfg)
    periods = unstack(params["blocks"], n_per)
    for j in range(n_per):
        for i, kind in enumerate(cfg.block_pattern):
            key = f"p{i}_{kind}"
            yield ("blocks", j), key, kind, periods[j][key]
    for i in range(n_rem):
        kind = cfg.block_pattern[i]
        key = f"r{i}_{kind}"
        yield ("rem", None), key, kind, params["rem"][key]


# ---------------------------------------------------------------------------
# Forward path
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embedding rows × sqrt(d_model), in the parameters'
    type and on their device."""
    emb = params["embed"]
    ids = tokens.to(emb.device).long()
    # the embedding op, whose sharding strategy takes ids sharded over
    # several mesh dims
    x = settle(F.embedding(ids, lookup_table(emb)))
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                            device=x.device)


def embed_inputs(params: Params, cfg: ArchConfig,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """(x [B,S,D], positions [1, S] (or the batch's ``positions``), the
    batch's ``positions3`` [3,B,S] or None).  x is, for an ``embeds``
    config, ``batch["embeds"]`` cast to the parameters' type and not
    scaled; else the token embeddings × sqrt(d_model), in the parameters'
    type.  Inputs move to the parameters' device."""
    if cfg.input_mode == "embeds":
        x = batch["embeds"].to(params["embed"].device, _dtype(cfg))
    else:
        x = embed_tokens(params, cfg, batch["tokens"])
    x = constrain(x, "bsd")
    S = x.shape[1]
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    pos3 = batch.get("positions3")
    if pos3 is not None:
        pos3 = pos3.to(x.device)
    return x, pos.to(x.device), pos3


def unembed(params: Params, cfg: ArchConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = apply_norm(cfg.norm_kind, x, params.get("final_norm"))
    if cfg.tie_embeddings:
        logits = torch.matmul(x.float(),
                              gather_weights(params["embed"]).float().t())
    else:
        logits = einsum_f32("bsd,dv->bsv", x,
                            gather_weights(params["lm_head"]))
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return constrain(logits, "bsv")


#: the matrix products whose outputs ``remat_policy="dots"`` saves
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _rematerialised(fn, policy: str):
    """``fn`` recomputed in the backward pass: nothing inside saved
    ("full"), or the matrix products' outputs saved ("dots")."""
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}")
    kw: Dict[str, Any] = dict(use_reentrant=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: ckpt.checkpoint(fn, *args, **kw)


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True, remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. Returns (logits [B,S,V] f32, aux_loss: the
    sum of the MoE layers' aux losses in layer order, 0 without MoE).
    With ``remat``, grad mode on and a parameter requiring grad, each
    period is rematerialised under ``remat_policy`` (see the module doc);
    otherwise (serving) the periods run as they are."""
    x, pos, pos3 = embed_inputs(params, cfg, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_per, n_rem = group_layout(cfg)

    def period_body(x, aux, period):
        period = gather_weights(period)
        for i, kind in enumerate(cfg.block_pattern):
            x, a = apply_block(cfg, kind, period[f"p{i}_{kind}"], x, pos,
                               pos3)
            if a is not None:
                aux = aux + a
        return x, aux

    body = period_body
    if remat and torch.is_grad_enabled() and any(
            p.requires_grad for _, p in leaves(params)):
        body = _rematerialised(period_body, remat_policy)
    for period in unstack(params["blocks"], n_per):
        x, aux = body(x, aux, period)
    for i in range(n_rem):
        kind = cfg.block_pattern[i]
        x, a = apply_block(cfg, kind,
                           gather_weights(params["rem"][f"r{i}_{kind}"]), x,
                           pos, pos3)
        if a is not None:
            aux = aux + a
    return unembed(params, cfg, x), aux


def gold_logits(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lg[..., labels]``: the logits [B,S,V] at the labels [B,S].  On
    DTensors by a mask and a sum over the vocabulary: a gather's backward
    makes its gradient with ``new_zeros`` of the whole [B,S,V], which
    DTensor replicates on every rank."""
    if not isinstance(lg, DTensor):
        return torch.gather(lg, -1, labels[..., None])[..., 0]
    hit = labels[..., None] == torch.arange(lg.shape[-1],
                                            device=labels.device)
    return torch.where(hit, lg, 0.0).sum(-1)


def lm_loss(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True, aux_weight: float = 0.01,
            remat_policy: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ ``aux_weight`` × the MoE aux loss), f32.
    Labels default to the shifted tokens; an ``embeds`` batch supplies
    ``labels`` (negative ones are ignored).  Returns (total, {"loss",
    "aux"})."""
    logits, aux = forward(params, cfg, batch, remat, remat_policy)
    if "labels" in batch:
        labels = batch["labels"].to(logits.device).long()
        valid = labels >= 0
        lg, lb = logits, torch.clamp_min(labels, 0)
    else:
        lg = logits[:, :-1]
        lb = batch["tokens"].to(logits.device).long()[:, 1:]
        valid = torch.ones_like(lb, dtype=torch.bool)
    logz = torch.logsumexp(lg, dim=-1)
    gold = gold_logits(lg, lb)
    nll = (logz - gold) * valid
    loss = nll.sum() / torch.clamp_min(valid.sum(), 1)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def _cache_len_for(cfg: ArchConfig, kind: str, max_seq: int) -> int:
    w = _window_for(cfg, kind)
    return min(max_seq, w) if w > 0 else max_seq


def _block_cache_specs(cfg: ArchConfig, kind: str, batch: int,
                       max_seq: int) -> Dict[str, TensorSpec]:
    dt = _dtype(cfg)
    if kind in ATTN_KINDS:
        L = _cache_len_for(cfg, kind, max_seq)
        kv = TensorSpec((batch, L, cfg.n_kv_heads, cfg.head_dim), dt)
        return {"k": kv, "v": kv}
    if kind == "rglru":
        Dr, K = cfg.d_rec_actual, cfg.conv_width
        return {"h": TensorSpec((batch, Dr), torch.float32),
                "conv": TensorSpec((batch, K - 1, Dr), dt)}
    if kind == "mlstm":
        H, hd = cfg.n_heads, cfg.head_dim
        return {"S": TensorSpec((batch, H, hd, hd), torch.float32),
                "n": TensorSpec((batch, H, hd), torch.float32),
                "m": TensorSpec((batch, H), torch.float32)}
    if kind == "slstm":
        return {k: TensorSpec((batch, cfg.d_model), torch.float32)
                for k in ("c", "n", "h", "m")}
    raise _unknown(kind)


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int) -> Params:
    """Decode-state tree: shapes and types of every leaf."""
    n_per, n_rem = group_layout(cfg)
    cache: Params = {"blocks": {
        f"p{i}_{kind}": _stack(_block_cache_specs(cfg, kind, batch, max_seq),
                               n_per)
        for i, kind in enumerate(cfg.block_pattern)}}
    if n_rem:
        cache["rem"] = {f"r{i}_{cfg.block_pattern[i]}": _block_cache_specs(
            cfg, cfg.block_pattern[i], batch, max_seq) for i in range(n_rem)}
    return cache


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: DeviceLike = "cuda") -> Params:
    """Zeros over :func:`cache_specs` on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    return map_tree(
        lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
        cache_specs(cfg, batch, max_seq))


def _assemble(cfg: ArchConfig, per_layer: Dict[str, list],
              rem: Dict[str, Params], blocks_default: Params) -> Params:
    """A cache tree from per-period block caches and remainder caches."""
    n_per, n_rem = group_layout(cfg)
    if n_per > 0:
        blocks = {key: {f: torch.stack([c[f] for c in caches])
                        for f in caches[0]}
                  for key, caches in per_layer.items()}
    else:
        blocks = blocks_default
    cache: Params = {"blocks": blocks}
    if n_rem:
        cache["rem"] = rem
    return cache


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _decode_attn(cfg: ArchConfig, p: Params, c: Params, x: torch.Tensor,
                 pos: int, pos3: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Params]:
    """x [B,1,D]; ring-buffer cache write + masked attention."""
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    q, k, v = _project_qkv(p, h)
    pos_t = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = _rotate(cfg, q, pos_t, pos3)
    k = _rotate(cfg, k, pos_t, pos3)
    L = c["k"].shape[1]
    slot = pos % L
    kc, vc = c["k"].clone(), c["v"].clone()
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    cache_len = torch.full((x.shape[0],), min(pos + 1, L),
                           dtype=torch.int32, device=x.device)
    att = decode_attention(q, kc, vc, cache_len, softcap=cfg.attn_softcap)
    x = x + heads_out(att, p["wo"])
    return _ffn(cfg, p, x)[0], {"k": kc, "v": vc}


def _decode_rglru(cfg: ArchConfig, p: Params, c: Params, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Params]:
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    y, st = rec.rglru_block_step(h[:, 0], rec.RGLRUState(c["h"], c["conv"]),
                                 p)
    x = x + y[:, None, :].to(x.dtype)
    return _ffn(cfg, p, x)[0], {"h": st.h,
                                "conv": st.conv.to(c["conv"].dtype)}


def _decode_mlstm(cfg: ArchConfig, p: Params, c: Params, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Params]:
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    q, k, v, log_f, log_i = (t[:, 0] for t in _mlstm_inputs(p, h))
    y, st = rec.mlstm_step(q, k, v, log_f, log_i,
                           rec.MLSTMState(c["S"], c["n"], c["m"]))
    og = torch.sigmoid(einsum("bd,de->be", h[:, 0], p["w_og"]))
    out = heads_out(y, p["w_out"]) * og
    return (x + out[:, None, :].to(x.dtype),
            {"S": st.S, "n": st.n, "m": st.m})


def _decode_slstm(cfg: ArchConfig, p: Params, c: Params, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Params]:
    h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
    y, (cn, nn, hn, mn) = rec.slstm_seq(h[:, :1], p, state=(
        c["c"], c["n"], c["h"], c["m"]))
    return x + y.to(x.dtype), {"c": cn, "n": nn, "h": hn, "m": mn}


def _decode_block(cfg: ArchConfig, kind: str, p: Params, c: Params,
                  x: torch.Tensor, pos: int, pos3: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, Params]:
    if kind in ATTN_KINDS:
        return _decode_attn(cfg, p, c, x, pos, pos3)
    if kind == "rglru":
        return _decode_rglru(cfg, p, c, x)
    if kind == "mlstm":
        return _decode_mlstm(cfg, p, c, x)
    if kind == "slstm":
        return _decode_slstm(cfg, p, c, x)
    raise _unknown(kind)


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                batch: Dict[str, Any]) -> Tuple[torch.Tensor, Params]:
    """One decode step. batch: tokens [B,1] (or, for an ``embeds`` config,
    embeds [B,1,D]), pos (current absolute position: an int or a
    one-element tensor) and optionally positions3 [3,B,1].  Returns
    (logits [B,1,V], new cache); the old cache is left as it was."""
    x, _, pos3 = embed_inputs(params, cfg, {
        k: batch[k] for k in ("tokens", "embeds", "positions3")
        if k in batch})
    pos = batch["pos"]
    pos = int(pos.reshape(-1)[0]) if isinstance(pos, torch.Tensor) \
        else int(pos)
    per_layer: Dict[str, list] = {}
    rem: Params = {}
    for (group, j), key, kind, p in _layers(cfg, params):
        c = (take(cache["blocks"][key], j) if group == "blocks"
             else cache["rem"][key])
        x, nc = _decode_block(cfg, kind, p, c, x, pos, pos3)
        if group == "blocks":
            per_layer.setdefault(key, []).append(nc)
        else:
            rem[key] = nc
    return unembed(params, cfg, x), _assemble(cfg, per_layer, rem,
                                              cache["blocks"])


# ---------------------------------------------------------------------------
# Prefill: forward + cache fill (the serving path's prompt)
# ---------------------------------------------------------------------------

def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            max_seq: int) -> Tuple[torch.Tensor, Params]:
    """Process a prompt of length S; returns (logits [B,S,V], filled cache)
    sized ``max_seq`` (ring-buffered for local attention), exactly as the
    reference fills it: a local-attention cache holds the last L positions
    at slot pos % L, an RG-LRU one the last state and the last K-1
    pre-conv inputs, an sLSTM one the recurrence's final state.  An
    mLSTM block's state is recomputed by the reference's sequential
    :func:`~repro_torch.models.recurrent.mlstm_step` loop over the S
    positions (one step a position on the host), not from the chunked
    form, so that the cache is the reference's."""
    x, pos, pos3 = embed_inputs(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    per_layer: Dict[str, list] = {}
    rem: Params = {}
    for (group, _), key, kind, p in _layers(cfg, params):
        if kind in ATTN_KINDS:
            x, _, (k, v) = _apply_attn_block(cfg, kind, p, x, pos, pos3)
            L = _cache_len_for(cfg, kind, max_seq)
            if S >= L:
                # the ring holds the last L positions, aligned to pos % L
                kc = torch.roll(k[:, S - L:], S % L, dims=1)
                vc = torch.roll(v[:, S - L:], S % L, dims=1)
            else:
                shape = (B, L, cfg.n_kv_heads, cfg.head_dim)
                kc = torch.zeros(shape, dtype=_dtype(cfg), device=x.device)
                vc = torch.zeros_like(kc)
                kc[:, :S] = k
                vc[:, :S] = v
            c = {"k": kc.to(_dtype(cfg)), "v": vc.to(_dtype(cfg))}
        elif kind == "rglru":
            x, hs, r = _rglru_mix(cfg, p, x)
            x = _ffn(cfg, p, x)[0]
            K = cfg.conv_width
            conv_state = torch.stack([r[:, S - K + 1 + i]
                                      for i in range(K - 1)], dim=1)
            # a copy, so the cache does not keep the whole of hs alive
            c = {"h": hs[:, -1].float().clone(), "conv": conv_state}
        elif kind == "mlstm":
            h = apply_norm(cfg.norm_kind, x, p.get("ln1"))
            x_out = _apply_mlstm_block(cfg, p, x)
            q, k, v, log_f, log_i = _mlstm_inputs(p, h)
            H, hd = cfg.n_heads, cfg.head_dim
            f32 = dict(dtype=torch.float32, device=x.device)
            st = rec.MLSTMState(torch.zeros((B, H, hd, hd), **f32),
                                torch.zeros((B, H, hd), **f32),
                                torch.zeros((B, H), **f32))
            for t in range(S):
                _, st = rec.mlstm_step(q[:, t], k[:, t], v[:, t],
                                       log_f[:, t], log_i[:, t], st)
            x = x_out
            c = {"S": st.S, "n": st.n, "m": st.m}
        elif kind == "slstm":
            x, (cn, nn, hn, mn) = _apply_slstm_block(cfg, p, x)
            c = {"c": cn, "n": nn, "h": hn, "m": mn}
        else:
            raise _unknown(kind)
        if group == "blocks":
            per_layer.setdefault(key, []).append(c)
        else:
            rem[key] = c
    return unembed(params, cfg, x), _assemble(cfg, per_layer, rem, {})
