"""Streaming fleet monitor on the card: online ingestion, correction and
query serving (the counterpart of :mod:`repro.core.stream`).

* :mod:`.state` — per-device accumulators and the recent-sample ring;
* :mod:`.estimators` — online update-period estimator, §5 corrections;
* :mod:`.ingest` — :class:`IngestCore`, the write side and hot path;
* :mod:`.snapshot` — :class:`MonitorSnapshot`, cloned epoch views;
* :mod:`.monitor` — :class:`MonitorService`, the façade;
* :mod:`.replay` — :func:`replay`, a ``SensorBank`` as a live stream.
"""
from repro_torch.core.stream.estimators import (OnlinePeriodEstimator,
                                                StreamCorrections,
                                                default_calibrations)
from repro_torch.core.stream.ingest import IngestCore, IngestReport
from repro_torch.core.stream.monitor import MonitorService
from repro_torch.core.stream.replay import replay
from repro_torch.core.stream.snapshot import FleetEnergy, MonitorSnapshot

__all__ = ["FleetEnergy", "IngestCore", "IngestReport", "MonitorService",
           "MonitorSnapshot", "OnlinePeriodEstimator", "StreamCorrections",
           "default_calibrations", "replay"]
