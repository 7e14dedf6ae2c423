"""The ingest core's ``ingest.health`` phase (the hardened monitor's health
step), read as :mod:`portbench.spans` reads the other phases: the card's
idle a slab while ``ingest.health`` is the innermost open phase, and the
host time under it.  A program without the phase gives None."""
from __future__ import annotations

from typing import Optional

from portbench import spans

PHASE = "ingest.health"


def _program(ctx):
    prog = spans.program(ctx, "ingest")
    if prog is None or not any(s.name == PHASE for s in prog.spans):
        return None
    return prog


def host_ms(ctx) -> Optional[float]:
    """Host ms a slab under ``ingest.health``."""
    prog = _program(ctx)
    if prog is None:
        return None
    ns = sum(s.t1_ns - s.t0_ns for s in prog.spans if s.name == PHASE)
    return ns * 1e-6 / prog.units


def idle_ms(ctx) -> Optional[float]:
    """The card's idle ms a slab while ``ingest.health`` is the innermost
    of the ingest phases open, its ``read.*`` span included."""
    prog = _program(ctx)
    if prog is None or not ctx.trace.device_ops:
        return None
    phases = spans.PHASES["ingest"] + (PHASE,)
    busy = ctx.trace.busy()
    total = 0.0
    for (lo, hi), top in prog.pairs:
        own = [(*prog.us(s), s.name) for s in prog.spans
               if s.root == top.id and s.name in phases]
        gaps = spans._gaps(busy, lo, hi)
        total += spans._overlap(gaps, spans._pieces(own, lo, hi)).get(
            PHASE, 0.0)
    return 1e3 * total / prog.units
