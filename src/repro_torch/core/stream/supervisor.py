"""Crash-recovery supervisor: a checkpointed ingest loop that survives
kills.

The counterpart of :mod:`repro.core.stream.supervisor`.
:class:`MonitorSupervisor` wraps a monitor's ingest loop with:

* auto-checkpoints at slab boundaries (every ``checkpoint_every``
  slabs, :func:`~.checkpoint.save_monitor`), each stamping the slab
  cursor into the manifest meta (``extras={"slab_seq": seq}``);
* restore-then-resume: :meth:`MonitorSupervisor.start` restores the
  newest complete generation under the root (``fallback=True``) and
  takes the slab cursor from its meta; ``factory()`` builds a fresh
  monitor only when there is no checkpoint;
* crash handling: an exception from the slab source or the ingest path
  restores and retries, with an optional backoff, up to
  ``max_restores`` times;
* slab-boundary dedup: the source is replayed from its start on every
  (re)start and slabs with ``seq <=`` the cursor are skipped, so no slab
  is folded twice.

For a deterministic slab source (one that yields the same slabs on every
call), a run killed at any slab boundary and resumed here answers every
query bitwise as a run that was never interrupted.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional, Tuple

from repro_torch._device import DeviceLike
from repro_torch.core.stream.checkpoint import (MissingCheckpointError,
                                                restore_monitor,
                                                save_monitor)

#: ``(seq, dev, ts, vs)``: arrays or tensors, as ``ingest`` takes them
Slab = Tuple[int, object, object, object]


@dataclasses.dataclass
class SupervisorReport:
    """Outcome of one :meth:`MonitorSupervisor.run`."""

    n_slabs: int = 0        #: slabs folded into the monitor this run
    n_skipped: int = 0      #: slabs skipped by the dedup cursor
    n_crashes: int = 0      #: exceptions caught from source or ingest
    n_restores: int = 0     #: successful restore-then-resume cycles
    n_checkpoints: int = 0  #: checkpoints written (the final one too)
    resumed_from: Optional[int] = None  #: slab cursor found at start()
    last_seq: int = -1      #: newest slab seq folded or skipped


class MonitorSupervisor:
    """A monitor's ingest loop with checkpoint and restore.

    ``factory`` builds a fresh monitor for a cold start (not called when
    a checkpoint restores); restores build the monitor on ``device``.
    The ``slab_source`` of :meth:`run` is a zero-argument callable
    returning an iterable of ``(seq, dev, ts, vs)`` with ``seq`` strictly
    increasing from 0; it is called again from the top after every
    restore and must yield the same slabs each time."""

    def __init__(self, factory: Callable[[], object], root: str, *,
                 checkpoint_every: int = 8, retain: int = 3,
                 max_restores: int = 8, backoff_s: float = 0.0,
                 asynchronous: bool = False, device: DeviceLike = "cuda"):
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if max_restores < 0:
            raise ValueError("max_restores must be >= 0")
        self.factory = factory
        self.root = root
        self.checkpoint_every = int(checkpoint_every)
        self.retain = int(retain)
        self.max_restores = int(max_restores)
        self.backoff_s = float(backoff_s)
        self.asynchronous = bool(asynchronous)
        self.device = device
        self.monitor = None
        self._seq_done = -1
        self._ckpt_seq = -1
        self._mgr = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, report: Optional[SupervisorReport] = None):
        """Restore the newest complete checkpoint (or build fresh) and
        position the slab cursor; returns the live monitor."""
        self.wait()
        try:
            mon, meta = restore_monitor(self.root, device=self.device,
                                        fallback=True, with_meta=True)
            self._seq_done = int(meta.get("slab_seq", -1))
            if report is not None:
                report.resumed_from = self._seq_done
        except MissingCheckpointError:
            mon = self.factory()
            self._seq_done = -1
        self._ckpt_seq = self._seq_done
        self.monitor = mon
        return mon

    def checkpoint(self, *, step: Optional[int] = None) -> None:
        """Write one checkpoint now, stamping the slab cursor."""
        self._mgr = save_monitor(
            self.monitor, self.root, step=step, retain=self.retain,
            asynchronous=self.asynchronous,
            extras={"slab_seq": self._seq_done})
        self._ckpt_seq = self._seq_done

    def wait(self) -> None:
        """Drain a pending asynchronous checkpoint write."""
        if self._mgr is not None:
            self._mgr.wait()

    # -- the supervised loop -----------------------------------------------
    def run(self, slab_source: Callable[[], Iterable[Slab]], *,
            grid: bool = False) -> SupervisorReport:
        """Fold every slab of ``slab_source`` into the monitor
        (``ingest_grid`` with ``grid=True``), checkpointing every
        ``checkpoint_every`` slabs and restoring and resuming on crashes.
        A final checkpoint is written once the source drains; the last
        exception re-raises once ``max_restores`` is spent.  The live
        monitor is ``self.monitor``."""
        report = SupervisorReport()
        if self.monitor is None:
            self.start(report)
        restores_left = self.max_restores
        while True:
            try:
                for seq, dev, ts, vs in slab_source():
                    if seq <= self._seq_done:
                        report.n_skipped += 1
                        report.last_seq = max(report.last_seq, int(seq))
                        continue
                    if grid:
                        self.monitor.ingest_grid(dev, ts, vs)
                    else:
                        self.monitor.ingest(dev, ts, vs)
                    self._seq_done = int(seq)
                    report.n_slabs += 1
                    report.last_seq = max(report.last_seq, int(seq))
                    if (seq + 1) % self.checkpoint_every == 0:
                        self.checkpoint(step=int(seq))
                        report.n_checkpoints += 1
                break
            except Exception:
                report.n_crashes += 1
                if restores_left == 0:
                    raise
                restores_left -= 1
                if self.backoff_s > 0.0:
                    time.sleep(self.backoff_s)
                self.start()
                report.n_restores += 1
        if self._seq_done > self._ckpt_seq:
            self.checkpoint(step=self._seq_done)
            report.n_checkpoints += 1
        self.wait()
        return report
