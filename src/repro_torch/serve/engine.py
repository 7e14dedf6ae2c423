"""Batched serving engine: slot-based continuous batching (a port of
:mod:`repro.serve.engine`).

A fixed pool of ``n_slots`` sequences decodes in lockstep (one
``decode_step`` per tick for the whole batch); finished slots are
refilled from the request queue, their prompt fed token by token through
``decode_step``.  As in the reference, every such step runs the whole
batch at one shared position, so feeding one slot's prompt also writes
the other slots' KV rings and RG-LRU states, and a tick decodes every
active slot at the largest active position: a request's tokens depend on
its neighbours (ROADMAP C lists this reference-side fault; the port keeps
it so that both engines give the same tokens).

An ``embeds`` config (qwen2-vl) is fed, as in the reference, the rows of
``params["embed"]`` for its tokens, unscaled, and no ``positions3``:
its attention then rotates by plain RoPE.  An encoder–decoder config is
refused, as the reference's engine refuses it; it is served through
``encdec.init_cache_from_encoder`` and ``encdec.decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api, transformer


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Decoder-only serving on ``device`` (the card by default), where
    ``params`` must lie."""

    def __init__(self, cfg: ArchConfig, params: Any, n_slots: int = 4,
                 max_seq: int = 256, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if cfg.encdec:
            raise ValueError("ServingEngine serves decoder-only models; an "
                             "encoder-decoder model decodes through "
                             "encdec.init_cache_from_encoder and "
                             "encdec.decode_step")
        for path, leaf in transformer.leaves(params):
            if leaf.device != self.device:
                raise ValueError(f"ServingEngine on {self.device}: parameter "
                                 f"{'/'.join(path)} is on {leaf.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.cache = api.init_cache(cfg, n_slots, max_seq, self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.queue: List[Request] = []
        self.ticks = 0

    # -- request management ------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fill_slots(self) -> None:
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                self._prefill_slot(s, self.queue.pop(0))

    def _decode(self, tokens: np.ndarray, pos: int) -> torch.Tensor:
        toks = torch.as_tensor(tokens, device=self.device)
        if self.cfg.input_mode == "embeds":
            batch = {"embeds": self.params["embed"][toks.long()], "pos": pos}
        else:
            batch = {"tokens": toks, "pos": pos}
        logits, self.cache = api.decode_step(self.params, self.cfg,
                                             self.cache, batch)
        return logits

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Feed the prompt token by token through decode_step for this
        slot, the other slots' tokens 0, at the shared position t."""
        self.slot_req[slot] = req
        self.slot_pos[slot] = 0
        for t, tok in enumerate(req.prompt):
            toks = np.zeros((self.n_slots, 1), np.int32)
            toks[slot, 0] = int(tok)
            self._decode(toks, t)
            self.slot_pos[slot] = t + 1

    # -- decoding ------------------------------------------------------------
    def step(self) -> int:
        """One decode tick for all active slots; returns #active."""
        self._fill_slots()
        active = [s for s in range(self.n_slots)
                  if self.slot_req[s] is not None]
        if not active:
            return 0
        toks = np.zeros((self.n_slots, 1), np.int32)
        for s in active:
            req = self.slot_req[s]
            toks[s, 0] = (req.generated[-1] if req.generated
                          else int(req.prompt[-1]))
        pos = int(max(self.slot_pos[s] for s in active))
        logits = self._decode(toks, pos)
        # argmax on the device, the first of equal maxima (np.argmax's rule)
        nxt = logits[:, 0].argmax(dim=-1).cpu().tolist()
        for s in active:
            req = self.slot_req[s]
            req.generated.append(int(nxt[s]))
            self.slot_pos[s] += 1
            if (len(req.generated) >= req.max_new_tokens
                    or self.slot_pos[s] >= self.max_seq - 1):
                req.done = True
                self.slot_req[s] = None
        self.ticks += 1
        return len(active)

    def run(self, max_ticks: int = 1000) -> List[Request]:
        """Tick until the queue and the slots are empty (or ``max_ticks``
        ticks in all); returns the requests finished in this call (the
        reference's ``run`` returns ``[]``)."""
        pending = list(self.queue) + [r for r in self.slot_req
                                      if r is not None]
        while self.queue or any(r is not None for r in self.slot_req):
            if self.ticks >= max_ticks:
                break
            self.step()
        return [r for r in pending if r.done]
