"""The monitor's readings, made on the card from the seed.

The fleet and its power are the audit's (:mod:`portbench.reference.audit`,
a frozen copy of the fleet scenario recipe): each device runs one workload
of the configuration's ``scenario_mix`` between ``idle_w`` and ``peak_w``,
starting ``start_offset_s`` into a cycle of ``pool_ticks`` ticks and idle
around it, seen through its sensor (the profile's update period and
averaging window, a hidden gain, offset and phase, jitter, quantised to
the profile's quantum).  A poll reads the newest published value, so a
held value changes once an update period, as nvidia-smi's does.  The
sensor's readings repeat with the cycle, which holds whole update periods.

The stream replays the cycle: slab ``i`` holds the readings of pool tick
``i % pool_ticks`` at the times of that tick advanced by whole cycles
(:meth:`MonitorTraffic.times`), so the window's only generator work is one
add over the times.  A device's job window is its workload's span in one
cycle of the first ``job_cycles``, drawn from the seed, so windows open
and close all through the stream a run ingests.  A ``grid`` mix hands out
``(ids [D], ts [M], v [D, M])``; a ``flat`` mix the tick flattened to
``(dev, t, v)`` with ``duplicate_share`` of its samples sent twice, in a
seeded random arrival order.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from portbench.reference.audit import AuditReference, fleet_names

F64, I64 = torch.float64, torch.int64
#: generator streams: one torch.Generator each, seeded seed * 8 + stream
_WINDOWS, _DUPLICATES, _ORDER = 2, 3, 4


def _generator(device: torch.device, seed: int, stream: int):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 8 + stream)
    return g


class MonitorTraffic:
    """The cell's readings and times on ``device``; see the module
    docstring.  ``pool`` [P, D, M] holds the cycle's readings, ``pool_ts``
    [P, M] its times, ``names`` each device's profile and ``labels`` its
    workload's scenario."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = dev = torch.device(device)
        self.config, self.seed = config, int(seed)
        self.n = d = int(config["n_devices"])
        self.names = fleet_names(config, d)
        poll = float(config["poll_period_s"])
        self.tick_s = float(config["tick_s"])
        self.m = round(self.tick_s / poll)
        self.pool_ticks = int(traffic["pool_ticks"])
        self.cycle_s = self.pool_ticks * self.tick_s
        self.layout = traffic["layout"]
        if self.layout not in ("grid", "flat"):
            raise ValueError(f"unknown layout '{self.layout}'")

        self.pool_ts = torch.stack([
            p * self.tick_s + torch.arange(self.m, dtype=F64, device=dev)
            * poll for p in range(self.pool_ticks)])
        dur = self._readings()
        self.ids = torch.arange(d, device=dev)
        self._last_ts = self.pool_ts[:, -1].tolist()
        g = _generator(dev, seed, _WINDOWS)
        cycle = torch.randint(0, int(traffic["job_cycles"]), (d,),
                              generator=g, device=dev)
        self.win_a = float(config["start_offset_s"]) + cycle.to(
            F64) * self.cycle_s
        self.win_b = self.win_a + dur
        self.dup_counts = None
        if self.layout == "flat":
            self._flatten(float(traffic.get("duplicate_share", 0.0)))

    # -- the readings ----------------------------------------------------
    def _readings(self) -> torch.Tensor:
        """Fills ``pool`` and ``labels``; returns each workload's span."""
        d, dev, cfg = self.n, self.device, self.config
        ref = AuditReference(cfg, F64, dev)
        rows = np.arange(d)
        (e, p, idle, ns), labels = ref.scenarios(self.seed, rows)
        self.labels = [str(x) for x in labels]
        dur = e[:, -1] - e[:, 0]
        start = float(cfg["start_offset_s"])
        bank = (e + (start - e[:, 0])[:, None], p, idle, ns)
        sens = ref.fleet(self.seed, rows)
        T, phase = sens["period"], sens["phase"]
        if bool((bank[0][:, -1] > self.cycle_s - T - sens["window"]).any()):
            raise ValueError("the cycle must end idle: more pool ticks")
        per = torch.round(self.cycle_s / T).to(I64)          # [D] updates
        if bool((torch.abs(per * T - self.cycle_s) > 1e-9).any()):
            raise ValueError("the cycle must hold whole update periods")
        k = torch.arange(int(per.max()), device=dev)[None, :]
        ticks = phase[:, None] + T[:, None] * k.to(F64)
        vals = ref.boxcar(sens, bank, ticks, k)               # [D, K]
        pool = torch.empty((self.pool_ticks, d, self.m), dtype=F64,
                           device=dev)
        for t in range(self.pool_ticks):
            at = torch.floor((self.pool_ts[t][None, :] - phase[:, None])
                             / T[:, None]).to(I64)
            pool[t] = torch.gather(vals, 1, torch.remainder(at, per[:, None]))
        self.pool = pool
        return dur

    # -- the flat layout ---------------------------------------------------
    def _flatten(self, share: float) -> None:
        """Each pool tick as (dev, t, v) with duplicates, permuted."""
        d, m, dev = self.n, self.m, self.device
        gd = _generator(dev, self.seed, _DUPLICATES)
        go = _generator(dev, self.seed, _ORDER)
        ids = torch.arange(d, device=dev).repeat_interleave(m)
        self.flat: List[Tuple[torch.Tensor, ...]] = []
        self.dup_counts = torch.zeros((self.pool_ticks, d), dtype=I64,
                                      device=dev)
        n_dup = round(share * d * m)
        self.n_sent = d * m + n_dup
        for p in range(self.pool_ticks):
            t = self.pool_ts[p].repeat(d)
            v = self.pool[p].reshape(-1)
            pick = torch.randint(0, d * m, (n_dup,), generator=gd,
                                 device=dev)
            dv, tv, vv = (torch.cat([x, x[pick]]) for x in (ids, t, v))
            self.dup_counts[p] = torch.bincount(ids[pick], minlength=d)
            order = torch.randperm(dv.numel(), generator=go, device=dev)
            self.flat.append((dv[order], tv[order], vv[order]))
            del dv, tv, vv, order, t, pick

    # -- the stream ------------------------------------------------------
    def times(self, i: int) -> torch.Tensor:
        """Slab ``i``'s poll times [M]: its pool tick's, a whole number of
        cycles on."""
        return self.pool_ts[i % self.pool_ticks] + (
            i // self.pool_ticks) * self.cycle_s

    def last_time(self, i: int) -> float:
        """Slab ``i``'s newest poll time, on the host (as :meth:`times`
        computes it)."""
        return self._last_ts[i % self.pool_ticks] + (
            i // self.pool_ticks) * self.cycle_s

    def slab(self, i: int):
        """The entry's arguments for slab ``i``."""
        p, c = i % self.pool_ticks, i // self.pool_ticks
        if self.layout == "grid":
            return self.ids, self.times(i), self.pool[p]
        dv, tv, vv = self.flat[p]
        return dv, tv + c * self.cycle_s, vv

    @property
    def samples_per_slab(self) -> int:
        """Distinct samples a slab carries (duplicates not counted)."""
        return self.n * self.m

    @property
    def sent_per_slab(self) -> int:
        """Samples a slab carries, duplicates counted."""
        return self.n * self.m if self.layout == "grid" else self.n_sent
