"""The hardened monitor cell's traffic: the fleet's readings
(:class:`~portbench.gen.monitor.MonitorTraffic`) sent flat through the
source's faults (:class:`~portbench.reference.faults.FaultPlan`).

Slab ``i`` carries the copies of slab ``i - 1`` held back one slab, then
slab ``i``'s own copies, each block in a seeded arrival order of its own.
A sample's reported time is :func:`~portbench.reference.faults.times` of
its poll in the cycle of the slab it was taken in, so a held copy carries
the same time bits as its twin.

The first ``warmup_slabs`` slabs, in which the dying devices die, are
emitted one by one at set-up.  From there on no device dies, the faults
repeat with the readings' cycle, and slab ``i`` is pool slab ``i %
pool_ticks``, emitted once at set-up without the dead devices: the
window's only generator work is the two operations over the times of
:func:`~portbench.reference.faults.times`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from portbench.gen.monitor import MonitorTraffic
from portbench.reference import faults

Block = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class FaultyTraffic:
    """The cell's faulted flat stream on ``device``; see the module
    docstring.  ``readings`` is the clean fleet (its ``pool``,
    ``pool_ts``, ``names``, ``labels``, ``win_a``/``win_b``), ``plan``
    the faults."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        if traffic["layout"] != "flat":
            raise ValueError("the faulted stream is flat")
        self.readings = r = MonitorTraffic(config, dict(traffic,
                                                        layout="grid"),
                                           seed, device)
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device, self.n, self.m = r.device, r.n, r.m
        self.pool_ticks, self.cycle_s = r.pool_ticks, r.cycle_s
        self.warmup = int(traffic["warmup_slabs"])
        self.plan = faults.FaultPlan(config, traffic, seed, r.pool_ts)
        # from the last warm-up slab on, a device lives for good or not
        live = self.plan.alive(self.warmup - 1)[:, :1]
        emitted = [self._emit(p, live) for p in range(self.pool_ticks)]
        self.pool = []
        for p in range(self.pool_ticks):
            front = emitted[(p - 1) % self.pool_ticks][1]
            self.pool.append(self._compose(front, emitted[p][0], p))
        self._warm = None

    # -- emission ----------------------------------------------------------
    def _emit(self, o: int, alive: torch.Tensor) -> Tuple[Block, Block]:
        """Origin slab ``o``'s copies (any ``o`` of pool tick ``o %
        pool_ticks``) as ``(own, held)`` blocks of (dev, base, step, v):
        the copies sent in the slab and those held back to the next."""
        p = o % self.pool_ticks
        plan, d, m = self.plan, self.n, self.m
        f = plan.flags(p)
        sent = alive & ~f["gone"]
        dev = torch.arange(d, device=self.device)[:, None].expand(d, m)
        base = plan.base(p)
        step = plan.step[:, None].expand(d, m)
        v = self.readings.pool[p]
        kind = f["kind"]
        v = torch.where(kind == faults.NAN_VALUE, float("nan"), v)
        v = torch.where(kind == faults.INF_VALUE, float("inf"), v)
        dev = torch.where(kind == faults.BAD_ID, dev + d, dev)
        base = torch.where(kind == faults.NAN_TIME, float("nan"), base)
        cols = (dev, base, step, v)
        own, held = [], []
        for copy, delay in ((sent, f["delay0"]), (sent & f["dup"],
                                                   f["delay1"])):
            own.append(tuple(x[copy & ~delay] for x in cols))
            held.append(tuple(x[copy & delay] for x in cols))
        return (tuple(torch.cat(x) for x in zip(*own)),
                tuple(torch.cat(x) for x in zip(*held)))

    def _compose(self, front: Optional[Block], own: Block, key: int):
        """One slab: ``front`` then ``own``, each in an order drawn from
        the seed and ``key``; the number of front samples comes back with
        it."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 64 + key) % 2 ** 63)
        blocks = [b for b in (front, own) if b is not None]
        out = []
        for b in blocks:
            order = torch.randperm(b[0].numel(), generator=g,
                                   device=self.device)
            out.append(tuple(x[order] for x in b))
        n_front = out[0][0].numel() if front is not None else 0
        return tuple(torch.cat(x) for x in zip(*out)), n_front

    def _warmup_slab(self, i: int):
        """Warm-up slab ``i``, emitted with the deaths (in order: each
        keeps the held copies for the next)."""
        if self._warm is None or self._warm[0] != i - 1:
            held = (None if i == 0 else
                    self._emit(i - 1, self.plan.alive(i - 1))[1])
        else:
            held = self._warm[1]
        own, nxt = self._emit(i, self.plan.alive(i))
        self._warm = (i, nxt)
        return self._compose(held, own, self.pool_ticks + i)

    # -- the stream --------------------------------------------------------
    def slab(self, i: int):
        """``(dev, t, v)`` of slab ``i``."""
        if i < self.warmup:
            (dev, base, step, v), n_front = self._warmup_slab(i)
        else:
            (dev, base, step, v), n_front = self.pool[i % self.pool_ticks]
        t = torch.empty_like(base)
        for part, c in ((slice(0, n_front), (i - 1) // self.pool_ticks),
                        (slice(n_front, None), i // self.pool_ticks)):
            faults.times(base[part], step[part], c, out=t[part])
        return dev, t, v

    def free(self) -> None:
        """Drop the emitted slabs (the readings stay for the reference)."""
        self.pool = None
        self._warm = None
