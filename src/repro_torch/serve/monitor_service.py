"""Batched query serving over the streaming fleet monitor.

The counterpart of :mod:`repro.serve.monitor_service`: callers ``submit``
any mix of ``fleet_energy`` / ``window_energy`` / ``energy_between`` /
``by_label`` queries and ``flush`` runs the whole batch against one
:class:`~repro_torch.core.stream.snapshot.MonitorSnapshot`:

* all distinct query instants of a flavour collapse into one
  ``snapshot_energy_at`` call on the card ([Q, N]);
* results are memoised in an LRU cache keyed ``(query, epoch)``, so a
  result is never served against another snapshot than its own;
* duplicate queries inside one batch are computed once and fanned out;
* ``fleet_energy`` and ``by_label`` answers go through the snapshot's
  ``fleet_from_rows`` and ``label_stats``, so on a health-tracked monitor
  they leave quarantined devices out exactly as the direct path does.

Usage::

    svc = MonitorQueryService(mon)
    tickets = [svc.submit(MonitorQuery.fleet_energy(t)) for t in instants]
    results = svc.flush()               # {ticket: FleetEnergy}
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.stream.monitor import MonitorService
from repro_torch.core.stream.snapshot import MonitorSnapshot

_KINDS = ("fleet_energy", "window_energy", "energy_between", "by_label")


@dataclasses.dataclass(frozen=True)
class MonitorQuery:
    """One hashable monitor query (build via the factory classmethods —
    they validate the edge contract at construction, so a malformed
    query fails at submit time, not deep inside a batch)."""

    kind: str
    t: Optional[float] = None
    t0: Optional[float] = None
    t1: Optional[float] = None
    corrected: bool = True

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown query kind '{self.kind}'; "
                             f"known: {', '.join(_KINDS)}")

    @classmethod
    def fleet_energy(cls, t: Optional[float] = None,
                     corrected: bool = True) -> "MonitorQuery":
        return cls("fleet_energy", t=None if t is None else float(t),
                   corrected=corrected)

    @classmethod
    def window_energy(cls, t: Optional[float] = None,
                      corrected: bool = True) -> "MonitorQuery":
        return cls("window_energy", t=None if t is None else float(t),
                   corrected=corrected)

    @classmethod
    def energy_between(cls, t0: float, t1: float,
                       corrected: bool = True) -> "MonitorQuery":
        t0, t1 = float(t0), float(t1)
        if not (t1 >= t0):        # also rejects NaN endpoints
            raise ValueError(f"bad window [{t0}, {t1}]")
        return cls("energy_between", t0=t0, t1=t1, corrected=corrected)

    @classmethod
    def by_label(cls, t0: Optional[float] = None,
                 t1: Optional[float] = None,
                 corrected: bool = True) -> "MonitorQuery":
        if (t0 is None) != (t1 is None):
            raise ValueError("pass both t0 and t1, or neither")
        if t0 is not None:
            t0, t1 = float(t0), float(t1)
            if not (t1 >= t0):
                raise ValueError(f"bad window [{t0}, {t1}]")
        return cls("by_label", t0=t0, t1=t1, corrected=corrected)


class MonitorQueryService:
    """Queue + batch executor + ``(query, epoch)`` LRU over one monitor.

    ``cache_size`` bounds the number of memoised results (fleet-energy
    answers carry [N] per-device arrays, so size the cache against
    ``n_devices`` — the default keeps a 100k-device monitor under
    ~250 MB worst-case).
    """

    def __init__(self, monitor: MonitorService, cache_size: int = 256):
        if cache_size < 0:
            raise ValueError("cache_size must be >= 0")
        self.monitor = monitor
        self.cache_size = int(cache_size)
        self._cache: "OrderedDict[Tuple[MonitorQuery, int], Any]" = \
            OrderedDict()
        self._pending: List[Tuple[int, MonitorQuery]] = []
        self._next_ticket = 0
        self.n_submitted = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_flushes = 0

    # -- request management ------------------------------------------------
    def submit(self, query: MonitorQuery) -> int:
        """Queue one query; returns the ticket that keys its result in
        the next :meth:`flush`."""
        if not isinstance(query, MonitorQuery):
            raise TypeError(f"submit takes a MonitorQuery, "
                            f"got {type(query).__name__}")
        ticket = self._next_ticket
        self._next_ticket += 1
        self.n_submitted += 1
        self._pending.append((ticket, query))
        return ticket

    def query(self, query: MonitorQuery):
        """Submit + flush a single query (convenience; batching still
        applies to whatever else is already queued)."""
        ticket = self.submit(query)
        return self.flush()[ticket]

    def query_many(self, queries: List[MonitorQuery]) -> List[Any]:
        """Submit a batch and flush once; results in input order.  The
        one-call shape the collector CLI uses for its replay summary —
        every distinct instant still collapses into one kernel call."""
        tickets = [self.submit(q) for q in queries]
        results = self.flush()
        return [results[t] for t in tickets]

    # -- execution ---------------------------------------------------------
    def flush(self) -> Dict[int, Any]:
        """Execute every pending query against the monitor's *current*
        snapshot and return ``{ticket: result}``.

        Cache hits are served without touching the snapshot arrays;
        misses are deduplicated, grouped by kind, and executed as one
        vectorized op per (kind, corrected) group.
        """
        if not self._pending:
            return {}
        snap = self.monitor.snapshot()
        epoch = snap.epoch
        self.n_flushes += 1
        pending, self._pending = self._pending, []

        # dedup: every distinct query computes once per flush
        tickets_for: "OrderedDict[MonitorQuery, List[int]]" = OrderedDict()
        for ticket, q in pending:
            tickets_for.setdefault(q, []).append(ticket)

        results: Dict[MonitorQuery, Any] = {}
        misses: List[MonitorQuery] = []
        for q in tickets_for:
            key = (q, epoch)
            if key in self._cache:
                self._cache.move_to_end(key)
                results[q] = self._cache[key]
                self.n_hits += len(tickets_for[q])
            else:
                misses.append(q)
                self.n_misses += len(tickets_for[q])

        for q, res in self._execute(snap, misses).items():
            results[q] = res
            if self.cache_size:
                self._cache[(q, epoch)] = res
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

        return {ticket: results[q]
                for q, ts in tickets_for.items() for ticket in ts}

    def _execute(self, snap: MonitorSnapshot,
                 misses: List[MonitorQuery]) -> Dict[MonitorQuery, Any]:
        """Run the deduplicated cache misses against one snapshot."""
        out: Dict[MonitorQuery, Any] = {}
        # collect every energy-at instant per corrected flavour:
        # fleet_energy(t) needs one row, energy_between(t0, t1) two
        for corrected in (True, False):
            instants: List[float] = []
            seen: Dict[float, int] = {}

            def row_of(t: float) -> int:
                if t not in seen:
                    seen[t] = len(instants)
                    instants.append(t)
                return seen[t]

            plan: List[Tuple[MonitorQuery, Tuple[int, ...]]] = []
            for q in misses:
                if q.corrected != corrected:
                    continue
                if q.kind == "fleet_energy" and q.t is not None:
                    plan.append((q, (row_of(q.t),)))
                elif q.kind in ("energy_between", "by_label") \
                        and q.t0 is not None:
                    plan.append((q, (row_of(q.t0), row_of(q.t1))))
            if plan:
                e, cov = snap.energy_at_batch(instants, corrected)
                for q, rows in plan:
                    if q.kind == "fleet_energy":
                        (r,) = rows
                        out[q] = snap.fleet_from_rows(
                            q.t, corrected, e[r].clone(), cov[r].clone())
                    else:
                        r0, r1 = rows
                        de, dc = snap.between_from_rows(
                            e[r0], cov[r0], e[r1], cov[r1])
                        if q.kind == "energy_between":
                            out[q] = (de, dc)
                        else:
                            out[q] = snap.label_stats(
                                de, dc & snap.state.has)

            # window_energy: all instants of a flavour in one broadcast
            wq = [q for q in misses
                  if q.kind == "window_energy" and q.corrected == corrected
                  and q.t is not None]
            if wq:
                wt = []
                wseen: Dict[float, int] = {}
                for q in wq:
                    if q.t not in wseen:
                        wseen[q.t] = len(wt)
                        wt.append(q.t)
                we = snap.window_energy_batch(wt, corrected)
                for q in wq:
                    out[q] = we[wseen[q.t]].clone()

        # the t=None / since-start variants read snapshot arrays directly
        for q in misses:
            if q in out:
                continue
            if q.kind == "fleet_energy":
                out[q] = snap.fleet_energy(None, q.corrected)
            elif q.kind == "window_energy":
                out[q] = snap.window_energy(None, q.corrected)
            elif q.kind == "by_label":
                out[q] = snap.by_label(None, None, q.corrected)
            else:                                    # pragma: no cover
                raise AssertionError(f"unplanned query {q}")
        return out

    # -- accounting --------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Executor counters: submissions, cache hit rate, flushes."""
        answered = self.n_hits + self.n_misses
        return {
            "n_submitted": self.n_submitted,
            "n_answered": answered,
            "n_pending": len(self._pending),
            "cache_hits": self.n_hits,
            "cache_misses": self.n_misses,
            "cache_hit_rate": (self.n_hits / answered) if answered else 0.0,
            "cache_entries": len(self._cache),
            "n_flushes": self.n_flushes,
        }
