"""Deterministic synthetic data pipeline: sharded, prefetched, resumable
(a port of :mod:`repro.data.pipeline`).

No dataset ships with the repository, so the pipeline synthesises a
reproducible token stream: batch ``i`` is a pure function of (seed,
step), which makes checkpoint/restart exact (the loader state is the
step counter) and multi-host sharding trivial (each host slices its rows
of the global batch).  Batches come out as numpy arrays drawn from the
reference's ``default_rng`` seeds, so they are bitwise the reference's;
the training loop moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeCell


@dataclasses.dataclass
class LoaderState:
    step: int = 0

    def to_dict(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "LoaderState":
        return cls(step=int(d["step"]))


class SyntheticTokens:
    """Markov-ish synthetic LM stream: deterministic per (seed, step)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeCell, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        if shape.global_batch % n_hosts:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = shape.global_batch // n_hosts
        self.state = LoaderState()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.local_batch, self.shape.seq_len
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        # zipfian-ish marginals so the loss signal is learnable
        z = rng.zipf(1.5, size=(B, S)).astype(np.int64)
        toks = (z % (self.cfg.vocab - 2)) + 1
        out: Dict[str, np.ndarray] = {}
        if self.cfg.encdec:
            out["src_embeds"] = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
            out["tokens"] = toks.astype(np.int32)
        elif self.cfg.input_mode == "embeds":
            out["embeds"] = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
            out["labels"] = toks.astype(np.int32)
            if self.cfg.mrope:
                out["positions3"] = np.broadcast_to(
                    np.arange(S, dtype=np.int32), (3, B, S)).copy()
        else:
            out["tokens"] = toks.astype(np.int32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self.state.step)
            self.state.step += 1
            yield b


class PrefetchLoader:
    """Background-thread prefetch (depth-N queue) over any batch source:
    the source's batches in order, none skipped."""

    def __init__(self, source: SyntheticTokens, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        def run():
            it = iter(self.source)
            batch = None
            while not self._stop.is_set():
                if batch is None:
                    batch = next(it)
                try:
                    # a full queue keeps the batch for the next try (the
                    # reference's loop drew a new one and lost it)
                    self.q.put(batch, timeout=0.2)
                    batch = None
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def next(self, timeout: float = 30.0) -> Dict[str, np.ndarray]:
        return self.q.get(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    @property
    def state(self) -> LoaderState:
        # prefetched but unconsumed batches are drawn again on resume:
        # exactness comes from batch_at() being a pure function of step
        return self.source.state
