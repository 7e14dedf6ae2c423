"""Mixture-of-experts FFN with capacity-based dispatch (a port of
:mod:`repro.models.moe`), in plain PyTorch: the reference computes it
outside any Pallas kernel, and its products are plain batched products
(cuBLAS on the card).

Step by step as the reference:

* **router**: f32 logits over the ``n_experts`` real experts, softmax,
  top-k, the top-k weights renormalised (floor 1e-9);
* **aux loss**: Switch-style, ``E · Σ_e density_e · mean prob_e`` over the
  top-1 expert, with ``E`` (not the padded count) columns;
* **capacity**: ``cap = int(max(1, (k·T_g·capacity_factor) // Ep))`` in
  Python floats, rounded up to a multiple of 128 (``Ep`` is the padded
  expert count, the experts' leading dimension);
* **slots**: an assignment's position in its expert is the number of
  earlier assignments to that expert, in token order over the group's
  flattened ``[T_g·k]`` assignments (an exclusive cumsum of their
  one-hot), so the
  latest tokens are the first dropped; a dropped assignment writes a
  trash slot that is sliced away and gets zero back;
* **experts**: batched products over ``[G, Ep, C, D]``, then the weighted
  gather back, plus the shared experts (:func:`gated_mlp`).

The dispatch is grouped as the reference's: one capacity slice a batch
shard, ``G = batch_groups()`` groups of ``T / G`` tokens (1 group, the
whole batch, without an activation-sharding context, or where G does not
divide T), each with its own capacity and slots, so that the scatter and
gather never cross data shards.  The padding experts
(``cfg.expert_pad_to``) receive no tokens.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_shard import batch_groups, constrain
from repro_torch.models.layers import activation, einsum, einsum_f32, gated_mlp

#: capacity per expert is rounded up to a multiple of this.  The
#: reference's module says 512 (its ``CAPACITY_ROUND``) but its
#: ``moe_ffn`` rounds to 128; the port follows the code.
CAPACITY_MULTIPLE = 128


class MoEOutput(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor


class Dispatch(NamedTuple):
    """One call's routing: router probabilities [T, E] (f32), the top-k
    experts [T, k] and whether each assignment was kept [T, k]."""
    probs: torch.Tensor
    topi: torch.Tensor
    keep: torch.Tensor


_records: Optional[List[Dispatch]] = None


@contextlib.contextmanager
def record_dispatch() -> Iterator[List[Dispatch]]:
    """Collect every :func:`moe_ffn` call's :class:`Dispatch`, in call
    order (one a MoE layer of a forward, prefill or decode step), while
    the context is open.  The tensors stay on their device."""
    global _records
    outer, _records = _records, []
    try:
        yield _records
    finally:
        _records = outer


def capacity(n_tokens: int, top_k: int, capacity_factor: float,
             n_experts_padded: int) -> int:
    """Slots per expert, as the reference computes them."""
    cap = int(max(1, (top_k * n_tokens * capacity_factor)
                  // n_experts_padded))
    return -(-cap // CAPACITY_MULTIPLE) * CAPACITY_MULTIPLE


def moe_ffn(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
            n_experts: int, top_k: int, capacity_factor: float = 1.25,
            act: str = "silu") -> MoEOutput:
    """x [B,S,D]; params: router [D,E], w_gate/w_up [Ep,D,F], w_down
    [Ep,F,D], optional shared_{gate,up,down}.  Returns (y [B,S,D] in the
    products' type, aux loss f32)."""
    B, S, D = x.shape
    E, k = n_experts, top_k
    Ep = params["w_gate"].shape[0]
    T = B * S
    xt = x.reshape(T, D)

    probs = torch.softmax(einsum_f32("td,de->te", xt, params["router"]),
                          dim=-1)                                # [T,E]
    topw, topi = torch.topk(probs, k, dim=-1)                    # [T,k]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    density = F.one_hot(topi[:, 0], E).float().mean(0)
    aux = E * torch.sum(density * probs.mean(0))

    # one capacity slice a batch shard (G groups), so that the scatter and
    # gather never cross data shards
    G = batch_groups()
    if T % G:
        G = 1
    Tg = T // G
    cap = capacity(Tg, k, capacity_factor, Ep)
    n_slots = Ep * cap
    flat_e = topi.reshape(G, Tg * k)
    onehot = F.one_hot(flat_e, Ep)                               # [G,Tgk,Ep]
    pos = (torch.cumsum(onehot, 1) - onehot).gather(
        2, flat_e[..., None])[..., 0]                            # before me
    keep = pos < cap
    lin = flat_e * cap + torch.clamp_max(pos, cap - 1)
    if _records is not None:
        _records.append(Dispatch(probs, topi, keep.reshape(T, k)))

    # slot -> assignment (sentinel Tg·k where empty); only the trash slot
    # n_slots takes more than one write, so no live slot depends on which
    # of several writes wins
    tok_ids = torch.arange(Tg * k, device=x.device).expand(G, Tg * k)
    slot_tok = torch.full((G, n_slots + 1), Tg * k, dtype=torch.long,
                          device=x.device)
    slot_tok = slot_tok.scatter(1, torch.where(keep, lin, n_slots), tok_ids)
    slot_tok = slot_tok[:, :n_slots]
    # the reference gathers from the [Tg·k, D] repeat of each group's
    # tokens; assignment a is a row of token a // k
    xg = constrain(xt.reshape(G, Tg, D), "gtd")
    rows = torch.clamp_max(slot_tok, Tg * k - 1) // k
    buf = torch.gather(xg, 1, rows[..., None].expand(G, n_slots, D))
    buf = torch.where((slot_tok < Tg * k)[..., None], buf,
                      torch.zeros((), dtype=buf.dtype, device=x.device))
    buf = constrain(buf.reshape(G, Ep, cap, D), "gecd")

    g = constrain(einsum("gecd,edf->gecf", buf, params["w_gate"]), "gecf")
    u = constrain(einsum("gecd,edf->gecf", buf, params["w_up"]), "gecf")
    ye = constrain(einsum("gecf,efd->gecd", activation(g, act) * u,
                          params["w_down"]), "gecd")

    back = torch.gather(ye.reshape(G, n_slots, D), 1,
                        lin[..., None].expand(G, Tg * k, D))     # [G,Tgk,D]
    back = torch.where(keep[..., None], back,
                       torch.zeros((), dtype=back.dtype, device=x.device))
    w = topw.reshape(G, Tg * k, 1).to(back.dtype)
    y = (back * w).reshape(G, Tg, k, D).sum(2).reshape(T, D)

    if "shared_gate" in params:
        y = y + gated_mlp(x, params["shared_gate"], params["shared_up"],
                          params["shared_down"], act=act).reshape(T, D)
    return MoEOutput(y.reshape(B, S, D), aux.float())
