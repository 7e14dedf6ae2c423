"""Spans and counters inside the program: which phase its host time goes
to, and which of its lines make the host wait for the card.

``with span("ingest.prep"): ...`` records a phase.  ``with
read("ingest.clean"): ...`` goes around a call that waits for the card (a
copy to or from it, ``bool()`` / ``int()`` / ``.tolist()`` / ``.cpu()`` of
a tensor, a boolean mask or ``nonzero``): it records the span
``read.ingest.clean`` and counts ``n`` under ``ingest.host_reads``, the
layer being the site's first dotted part.  ``count(name, n)`` adds to a
counter.  Kernel launches are counted by the kernel wrappers
(``.launches``), not here.

Recording is on while a ``torch.profiler`` profile runs, and then every
span also opens a profiler range under its name, so it sits in the
profiler's trace on the kernels' clock; it is on after :func:`enable`
too.  Otherwise :func:`span` and :func:`read` read two flags and hand
back one shared no-op context, and :func:`count` does nothing.

A span records ``(id, name, parent, root, thread, t0_ns, t1_ns)``:
``thread`` is ``threading.get_ident()``, ``parent`` the id of the span it
opened inside (on its own thread),
``root`` the id of its thread's outermost span, so one slab's or one
audit's spans share it; times are ``time.perf_counter_ns()``.  At most
:data:`LIMIT` spans are kept, and the rest are counted as dropped.
:func:`recorded` hands back what was kept and :func:`reset` clears it.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

#: spans kept before further ones are counted as dropped
LIMIT = 200_000


class Span(NamedTuple):
    id: int
    name: str
    parent: Optional[int]
    root: int
    thread: int
    t0_ns: int
    t1_ns: int


class Recorded(NamedTuple):
    """What the recorder holds: its spans in the order they closed, its
    counters and the number of spans it dropped past :data:`LIMIT`."""

    spans: List[Span]
    counters: Dict[str, int]
    dropped: int


class _Recorder:
    """The process's spans and counters; one lock guards them, each
    thread keeps its own stack of open spans."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, span: Span) -> None:
        with self.lock:
            if len(self.spans) < LIMIT:
                self.spans.append(span)
            else:
                self.dropped += 1

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)


_REC = _Recorder()
_OFF = contextlib.nullcontext()
#: the profiler's range in C++ (a microsecond where the Python
#: ``record_function`` takes tens), where this build of torch has it
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.profiler.record_function)


class _Open:
    """One span while it is open."""

    __slots__ = ("name", "id", "parent", "root", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Open":
        stack = _REC.stack()
        self.id = next(_REC.ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _REC.stack().pop()
        _REC.add(Span(self.id, self.name, self.parent, self.root,
                      threading.get_ident(), self.t0, t1))


def recording() -> bool:
    """Whether spans and counts are being recorded now."""
    return _REC.on or _profiler._is_profiler_enabled


def current() -> Optional[str]:
    """The name of the innermost span open on this thread, if any."""
    stack = _REC.stack()
    return stack[-1].name if stack else None


def span(name: str):
    """A context that records the span ``name`` while recording is on."""
    if not (_REC.on or _profiler._is_profiler_enabled):
        return _OFF
    return _Open(name)


def read(site: str, n: int = 1):
    """A span ``read.<site>`` around ``n`` calls that wait for the card,
    counted under ``<layer>.host_reads`` (``layer`` is the site's first
    dotted part)."""
    if not (_REC.on or _profiler._is_profiler_enabled):
        return _OFF
    _REC.count(site.split(".", 1)[0] + ".host_reads", n)
    return _Open("read." + site)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _REC.on or _profiler._is_profiler_enabled:
        _REC.count(name, n)


def enable() -> None:
    """Record from now on, with or without a profiler."""
    _REC.on = True


def disable() -> None:
    """Record only while a profiler runs (the default)."""
    _REC.on = False


def recorded() -> Recorded:
    """A copy of the spans, counters and dropped count recorded so far."""
    with _REC.lock:
        return Recorded(list(_REC.spans), dict(_REC.counters), _REC.dropped)


def reset() -> None:
    """Forget every span, counter and drop recorded so far."""
    with _REC.lock:
        _REC.spans.clear()
        _REC.counters.clear()
        _REC.dropped = 0
