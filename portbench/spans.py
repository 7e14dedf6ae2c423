"""The program's own spans and counters (``repro_torch.common.spans``),
read in the run's process after the window, on the traced stretch's
clock.

The program records while the profiler runs, so what it holds after a
``--trace 1`` run is the traced stretch's spans (times from
``time.perf_counter_ns``) and counters.  Each of portbench's ``ingest`` /
``audit`` spans (the trace's clock, microseconds) encloses one of the
program's top spans (:data:`TOPS`), so the offset between the clocks lies
in ``[max(a_i - s_i), min(b_i - e_i)]`` over the pairs, in order, of
portbench spans ``[a_i, b_i]`` and top spans ``[s_i, e_i]``; the map takes
the middle of that interval.  The residual is the farthest any top span,
so mapped, leaves the portbench span around it: 0 while the interval is
not empty, half its overlap once a clock jumps or drifts.  A call delayed
on its way into or out of the program (the first traced call, now and
then another: up to 155 us on a card's host) only widens its own pair's
room.

Each idle gap of the card inside a portbench span goes, instant by
instant, to the innermost of the program's phase spans (:data:`PHASES`)
then open under that slab's or audit's top span; a ``read.*`` span counts
toward its phase.

:func:`program` gives None, and so every metric that reads it, when the
program records nothing (a checkout without the recorder), when the pair
counts differ, when the residual exceeds :data:`MAX_RESIDUAL_US`, or when
the recorder dropped spans.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

#: the program's top spans, by the portbench span that encloses them
TOPS = {"ingest": ("ingest.grid", "ingest.flat"), "audit": ("audit.run",)}
#: the phase spans that partition a top span, by layer
PHASES = {"ingest": ("ingest.prep", "ingest.kernel", "ingest.fold",
                     "ingest.moments"),
          "audit": ("audit.bank", "audit.synth_wait", "audit.measure",
                    "audit.moments")}
#: the largest residual (us) at which the two clocks count as aligned
MAX_RESIDUAL_US = 50.0

Interval = Tuple[float, float]


def _recorded():
    try:
        from repro_torch.common import spans
    except ImportError:     # a program without the recorder
        return None
    return spans.recorded()


class Program:
    """One layer's program spans on the trace's clock: ``pairs`` [(outer
    interval, top span)], ``spans`` every span recorded, ``counters``, the
    ``offset_us`` that maps program time onto the trace's and
    ``residual_us``."""

    def __init__(self, layer, pairs, spans, counters, offset_us):
        self.layer = layer
        self.pairs = pairs
        self.spans = spans
        self.counters: Dict[str, int] = counters
        self.offset_us = offset_us
        self.residual_us = 0.0
        for (lo, hi), top in pairs:
            a, b = self.us(top)
            self.residual_us = max(self.residual_us, lo - a, b - hi)

    def us(self, span) -> Interval:
        """A program span's interval on the trace's clock."""
        return (span.t0_ns * 1e-3 + self.offset_us,
                span.t1_ns * 1e-3 + self.offset_us)

    @property
    def units(self) -> int:
        return len(self.pairs)

    def top_ms(self) -> List[float]:
        return [(s.t1_ns - s.t0_ns) * 1e-6 for _, s in self.pairs]

    def count(self, name: str) -> int:
        return int(self.counters.get(name, 0))

    def idle_by_phase(self, busy: List[Interval]) -> Dict[str, float]:
        """Seconds the card sat idle inside the portbench spans, by the
        innermost phase open at each instant (``other`` outside every
        phase, ``total`` the sum)."""
        by_root = defaultdict(list)
        phases = PHASES[self.layer]
        for s in self.spans:
            if s.name in phases:
                by_root[s.root].append(s)
        out = dict.fromkeys(phases + ("other", "total"), 0.0)
        for (lo, hi), top in self.pairs:
            own = [(*self.us(s), s.name) for s in by_root[top.id]]
            pieces = _pieces(own, lo, hi)
            gaps = _gaps(busy, lo, hi)
            for name, sec in _overlap(gaps, pieces).items():
                out[name] += sec
            out["total"] += sum(b - a for a, b in gaps) * 1e-6
        return out


def _gaps(busy: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The complement of ``busy`` (sorted, disjoint) inside [lo, hi]."""
    out, at = [], lo
    for a, b in busy:
        if b <= at:
            continue
        if a >= hi:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def _pieces(phases, lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """[lo, hi] cut into ordered pieces, each named by the innermost
    (latest opened) of ``phases`` [(t0, t1, name)] open over it, or
    ``other`` where none is."""
    cuts = sorted({lo, hi} | {t for t0, t1, _ in phases for t in (t0, t1)
                              if lo < t < hi})
    out: List[Tuple[float, float, str]] = []
    for u, v in zip(cuts, cuts[1:]):
        mid = 0.5 * (u + v)
        inner = max((p for p in phases if p[0] <= mid < p[1]),
                    key=lambda p: p[0], default=None)
        out.append((u, v, inner[2] if inner else "other"))
    return out


def _overlap(gaps: List[Interval], pieces) -> Dict[str, float]:
    """Seconds of ``gaps`` under each piece's name (both sorted)."""
    out: Dict[str, float] = defaultdict(float)
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            u, v, name = pieces[k]
            out[name] += (min(b, v) - max(a, u)) * 1e-6
            k += 1
    return out


def program(ctx, layer: str,
            limit_us: float = MAX_RESIDUAL_US) -> Optional[Program]:
    """The program's spans of ``layer`` (``ingest`` or ``audit``) aligned
    to the traced stretch of ``ctx``, or None (see the module; a
    residual over ``limit_us``)."""
    rec = _recorded()
    if rec is None or rec.dropped:
        return None
    outer = sorted(ctx.trace.spans.get(layer, []))
    tops = sorted((s for s in rec.spans
                   if s.parent is None and s.name in TOPS[layer]),
                  key=lambda s: s.t0_ns)
    if not outer or len(outer) != len(tops):
        return None
    lower = max(a - s.t0_ns * 1e-3 for (a, _), s in zip(outer, tops))
    upper = min(b - s.t1_ns * 1e-3 for (_, b), s in zip(outer, tops))
    offset = 0.5 * (lower + upper)
    prog = Program(layer, list(zip(outer, tops)), rec.spans, rec.counters,
                   offset)
    return prog if prog.residual_us <= limit_us else None


def phase_idle(ctx, layer: str) -> Optional[Tuple[Dict[str, float], int]]:
    """The card's idle seconds inside portbench's ``layer`` spans by phase
    (:meth:`Program.idle_by_phase`) and the number of those spans, or
    None (no device operations in the trace, or no aligned program)."""
    prog = program(ctx, layer)
    if prog is None or not ctx.trace.device_ops:
        return None
    return prog.idle_by_phase(ctx.trace.busy()), prog.units
