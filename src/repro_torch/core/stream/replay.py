"""Replay driver: run a :class:`~repro_torch.core.fleet_engine.SensorBank`
as a live poll-sample stream into a monitor.

The clean-stream part of :func:`repro.core.stream.replay.replay`: every
poll instant arrives exactly once, in order, through the monitor's
rectangular ``ingest_grid`` fast path (``grid=True``, the default) or the
flattened general ``ingest`` path (``grid=False``).  Fault injection and
``stream_fleet`` are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core.fleet_engine import SensorBank
from repro_torch.core.stream.monitor import MonitorService


def replay(bank: SensorBank, monitor: MonitorService, t0: float, t1: float,
           period_s: float = 0.001, tick_s: float = 0.5,
           chunk_devices: Optional[int] = None, *,
           grid: bool = True,
           progress: Optional[Callable] = None) -> Dict[str, int]:
    """Stream ``bank``'s poll grid over ``[t0, t1)`` into ``monitor`` slab
    by slab; ``progress(monitor, t_emitted)`` runs after each slab.
    Returns the monitor's counters after the replay."""
    for dev, t, v in bank.iter_poll_slabs(
            t0, t1, period_s=period_s, tick_s=tick_s,
            chunk_devices=chunk_devices, grid=grid):
        if grid:
            monitor.ingest_grid(dev, t, v)
        else:
            monitor.ingest(dev, t, v)
        if progress is not None:
            progress(monitor, float(t[-1]))
    return dict(monitor.counters)
