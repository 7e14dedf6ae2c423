"""The hardened monitor cell's fault model: every fault decision of its
traffic as a pure function of the seed and of the sample's address, so
that the generator (:mod:`portbench.gen.monitor_health`) can emit the
faulted stream on the card and the reference
(:mod:`portbench.reference.monitor_health`) can rebuild the decisions of
any device, pool tick and poll without the stream.

The faults are the source's ``FaultSpec`` fields, read from the traffic
mix.  A poll ``j`` of pool tick ``p`` on device ``d`` is emitted unless
its device is dead at its true time, a collector restart blacks it out
or it is dropped.  An emitted sample may be corrupted (one of four kinds,
in equal shares: NaN value, inf value, id + N, NaN time) and sent twice;
each copy is held back one slab on its own draw.  Per device: a clock
rate error and offset (the device reports ``skew + (1 + rate) * T`` of
true time ``T``), and a death poll for the ``dropout_fraction`` that die.
Restarts black out ``restart_blackout_s`` of polls fleet-wide.  The
readings repeat with the pool's cycle, and so do the restarts: every
cycle holds ``round(cycle / restart_every_s)`` of them at offsets drawn
uniformly from the seed (a Poisson process of that rate given its mean
count), so that every seed runs at the source's rate.

Uniforms come from a counter hash (splitmix64's finaliser over the int64
address plus a salt a draw stream), so they are the same on the CPU and
the card and need no generator state.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

F64, I64 = torch.float64, torch.int64
_M64 = (1 << 64) - 1
#: draw streams, one salt each
DROP, CORRUPT, KIND, DUP, DELAY0, DELAY1 = 1, 2, 3, 4, 5, 6
DRIFT, SKEW, DEAD, DEATH, RESTARTS = 7, 8, 9, 10, 11
#: the poll index of an event that never comes
NEVER = 2 ** 62
#: corruption kinds (0 is an intact sample)
NAN_VALUE, INF_VALUE, BAD_ID, NAN_TIME = 1, 2, 3, 4


def _signed(x: int) -> int:
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 ``x`` by ``s``."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ _srl(z, 30)) * _signed(0xBF58476D1CE4E5B9)
    z = (z ^ _srl(z, 27)) * _signed(0x94D049BB133111EB)
    return z ^ _srl(z, 31)


def salt(seed: int, stream: int) -> int:
    """The int64 salt of a draw stream of ``seed``."""
    return _signed(int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019
                   * (int(stream) + 1))


def uniform(seed: int, stream: int, ctr: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1), float64, one an int64 address in ``ctr``."""
    x = _mix(_mix(ctr.to(I64) + salt(seed, stream)))
    return _srl(x, 11).to(F64) * 2.0 ** -53


def times(base: torch.Tensor, step: torch.Tensor, c: int,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reported times in cycle ``c``: ``step * c + base``, two separately
    rounded float64 operations (the same bits on any device and layout),
    into ``out`` when given."""
    if out is None:
        return step * float(c) + base
    torch.mul(step, float(c), out=out)
    return out.add_(base)


class FaultPlan:
    """The fault decisions of one run: see the module docstring.

    ``drift``/``skew`` [D] the clock errors, ``step`` [D] one cycle of a
    device's reported time, ``death_poll`` [D] the absolute poll index at
    which a device dies (:data:`NEVER` for survivors) and ``revive_poll``
    [D] the one at which it reports again (:data:`NEVER`: the source's
    devices die for good), ``black`` [P, M] the polls that restarts black
    out.  Deaths and revivals fall before the last warm-up slab."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 pool_ts: torch.Tensor):
        self.seed = s = int(seed)
        self.device = dev = pool_ts.device
        self.d = d = int(config["n_devices"])
        self.p, self.m = (int(x) for x in pool_ts.shape)
        self.pool_ts = pool_ts
        self.tick_s = float(config["tick_s"])
        self.cycle_s = self.p * self.tick_s
        self.tr = tr = traffic
        rows = torch.arange(d, device=dev)
        self.drift = float(tr["clock_drift"]) * (
            2.0 * uniform(s, DRIFT, rows) - 1.0)
        self.skew = float(tr["clock_skew_s"]) * (
            2.0 * uniform(s, SKEW, rows) - 1.0)
        self.step = (1.0 + self.drift) * self.cycle_s
        # deaths: uniform over the last (1 - dropout_after) of the stream
        # before the last warm-up slab, so none reaches the window
        self.dead = uniform(s, DEAD, rows) < float(tr["dropout_fraction"])
        span = (int(tr["warmup_slabs"]) - 1) * self.m
        lo = float(tr["dropout_after"]) * span
        at = lo + uniform(s, DEATH, rows) * (span - lo)
        self.death_poll = torch.where(self.dead, torch.floor(at).to(I64),
                                      NEVER)
        self.revive_poll = torch.full_like(rows, NEVER)
        self.black = self._blackouts()

    def _blackouts(self) -> torch.Tensor:
        every = float(self.tr["restart_every_s"])
        width = float(self.tr["restart_blackout_s"])
        black = torch.zeros((self.p, self.m), dtype=torch.bool,
                            device=self.device)
        if not every:
            return black
        k = round(self.cycle_s / every)
        rng = np.random.default_rng((self.seed, RESTARTS))
        ts = self.pool_ts
        for t in rng.uniform(0.0, self.cycle_s, k):
            for x in (ts, ts + self.cycle_s):       # wraps into the next
                black |= (x >= t) & (x < t + width)
        return black

    def base(self, p: int) -> torch.Tensor:
        """[D, M] reported times of pool tick ``p`` in cycle 0."""
        return (self.skew[:, None]
                + (1.0 + self.drift)[:, None] * self.pool_ts[p][None, :])

    def alive(self, o) -> torch.Tensor:
        """[D, M] the polls of origin slab ``o`` (an int, or a tensor of
        one a device) taken while the device lives."""
        at = (torch.as_tensor(o, device=self.device).reshape(-1, 1)
              * self.m + torch.arange(self.m, device=self.device)[None, :])
        return ((at < self.death_poll[:, None])
                | (at >= self.revive_poll[:, None]))

    def flags(self, p: int, rows=None) -> Dict[str, torch.Tensor]:
        """Pool tick ``p``'s decisions, each [D, M] (or [R, M] for the
        devices ``rows``): ``gone`` (blacked out or dropped), ``kind``
        (int8: 0 intact, else the corruption), ``dup`` (sent twice),
        ``delay0``/``delay1`` (the first / second copy held back one
        slab)."""
        m, s, tr = self.m, self.seed, self.tr
        if rows is None:
            rows = torch.arange(self.d, device=self.device)
        ctr = ((rows[:, None] * self.p + p) * m
               + torch.arange(m, device=self.device)[None, :])
        gone = self.black[p][None, :] | (
            uniform(s, DROP, ctr) < float(tr["drop_fraction"]))
        hit = uniform(s, CORRUPT, ctr) < float(tr["corrupt_fraction"])
        kind = torch.where(
            hit, 1 + torch.floor(uniform(s, KIND, ctr) * 4.0).to(I64),
            0).to(torch.int8)
        delay = float(tr["delay_fraction"])
        return {"gone": gone, "kind": kind,
                "dup": uniform(s, DUP, ctr) < float(tr["dup_fraction"]),
                "delay0": uniform(s, DELAY0, ctr) < delay,
                "delay1": uniform(s, DELAY1, ctr) < delay}
