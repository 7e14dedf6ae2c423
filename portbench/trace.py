"""The traced stretch of a run: ``torch.profiler`` over a bounded steady
stretch, its Chrome trace read back into host spans, device operations
and runtime calls, and the reductions the per-layer metrics share.

Host spans are ``record_function`` ranges that ``portbench`` itself opens
around each call into a layer of the program (:data:`SPANS`); the whole
traced stretch is the span ``stretch``.  Device operations are kernels,
copies and sets.  The profiler writes host and device events on one
clock, in microseconds.
"""
from __future__ import annotations

import contextlib
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

#: the spans portbench opens around calls into the program's layers
SPANS = ("traffic", "ingest", "audit")
STRETCH = "stretch"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
#: runtime calls that wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")

Interval = Tuple[float, float]


def span(name: str):
    """A host span around one call into a layer (a few microseconds when
    no profiler runs)."""
    return torch.profiler.record_function(name)


def union(intervals: List[Interval]) -> List[Interval]:
    """Merge overlapping intervals: what overlapping streams (the audit's
    prefetch thread) run at once counts once."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


class TraceData:
    """One traced stretch: ``spans`` {name: [(t0, t1)]} (microseconds),
    ``device_ops`` [(name, t0, t1)], ``runtime`` [(name, t0, t1)] and the
    stretch ``(t0, t1)``."""

    def __init__(self, spans, device_ops, runtime, stretch):
        self.spans: Dict[str, List[Interval]] = spans
        self.device_ops: List[Tuple[str, float, float]] = device_ops
        self.runtime: List[Tuple[str, float, float]] = runtime
        self.stretch: Interval = stretch

    @classmethod
    def from_events(cls, events: List[dict]) -> "TraceData":
        spans: Dict[str, List[Interval]] = defaultdict(list)
        device_ops, runtime = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            t0 = float(e.get("ts", 0.0))
            t1 = t0 + float(e.get("dur", 0.0))
            if cat in _DEVICE_CATS:
                device_ops.append((name, t0, t1))
            elif cat in _RUNTIME_CATS:
                runtime.append((name, t0, t1))
            elif cat == "user_annotation" and (name in SPANS
                                               or name == STRETCH):
                spans[name].append((t0, t1))
        st = spans.pop(STRETCH, [])
        if st:
            stretch = (min(a for a, _ in st), max(b for _, b in st))
        else:       # no stretch span: the extent of everything recorded
            ts = [t for _, a, b in device_ops + runtime for t in (a, b)]
            ts += [t for iv in spans.values() for a, b in iv for t in (a, b)]
            stretch = (min(ts), max(ts)) if ts else (0.0, 0.0)
        return cls(dict(spans), device_ops, runtime, stretch)

    @classmethod
    def load(cls, path: Path) -> "TraceData":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls.from_events(events)

    # -- reductions ------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.stretch[1] - self.stretch[0]) * 1e-6

    def busy(self) -> List[Interval]:
        """The union of device operations inside the stretch."""
        return clip(union([(a, b) for _, a, b in self.device_ops]),
                    *self.stretch)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0.0 or not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_times(self, substring: str) -> List[float]:
        """Device seconds of each launch whose kernel name contains
        ``substring``."""
        return [(b - a) * 1e-6 for name, a, b in self.device_ops
                if substring in name]

    def span_times(self, name: str) -> List[float]:
        return [(b - a) * 1e-6 for a, b in self.spans.get(name, [])]

    def runtime_in(self, name: str, calls=SYNC_CALLS) -> int:
        """Runtime calls among ``calls`` made inside spans ``name``."""
        ivs = self.spans.get(name, [])
        n = 0
        for call, a, _ in self.runtime:
            if call in calls and any(lo <= a <= hi for lo, hi in ivs):
                n += 1
        return n

    def host_span_at(self, t: float) -> str:
        """The innermost portbench span the host was in at ``t``."""
        best, width = "none", float("inf")
        for name, ivs in self.spans.items():
            for a, b in ivs:
                if a <= t <= b and b - a < width:
                    best, width = name, b - a
        return best

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps, each named by the span the host was in halfway
        through it."""
        per: Dict[str, float] = defaultdict(float)
        lo, hi = self.stretch
        for name, a, b in self.device_ops:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                per[name] += (b - a) * 1e-6
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy()
        gaps = []
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b > a:
                gaps.append((self.host_span_at(0.5 * (a + b)), (b - a) * 1e-6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


class Profiled:
    """``with Profiled(cuda) as p: ...`` profiles the block as the span
    ``stretch``, synchronising the card before it ends.  Writing and
    reading the trace waits for :meth:`read`, which a run calls once its
    window has closed."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._stack = contextlib.ExitStack()

    def __enter__(self) -> "Profiled":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = self._stack.enter_context(
            torch.profiler.profile(activities=acts))
        self._stack.enter_context(span(STRETCH))
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self.cuda:
                torch.cuda.synchronize()
        finally:
            self._stack.close()

    def read(self, path: Path) -> TraceData:
        """Write the Chrome trace to ``path`` and read it back."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))
        return TraceData.load(path)
