"""Streaming fleet monitor on the card: online ingestion, correction and
query serving (the counterpart of :mod:`repro.core.stream`).

* :mod:`.state` — per-device accumulators and the recent-sample ring;
* :mod:`.estimators` — online update-period estimator, §5 corrections;
* :mod:`.ingest` — :class:`IngestCore`, the write side and hot path;
* :mod:`.snapshot` — :class:`MonitorSnapshot`, cloned epoch views;
* :mod:`.monitor` — :class:`MonitorService`, the façade;
* :mod:`.schema` — the versioned registries that checkpoints and
  ``nbytes()`` walk;
* :mod:`.health` — the opt-in health machine (healthy → stale →
  quarantined) behind degraded-mode queries;
* :mod:`.checkpoint` — bitwise save and restore in the reference's
  layout, with typed corruption errors and fallback to the newest
  complete generation;
* :mod:`.supervisor` — :class:`MonitorSupervisor`, the crash-recovery
  loop (auto-checkpoint, restore-then-resume, slab-boundary dedup);
* :mod:`.replay` — :func:`replay`, a ``SensorBank`` as a live stream.
"""
from repro_torch.core.stream.checkpoint import (CheckpointError,
                                                MissingCheckpointError,
                                                restore_monitor,
                                                save_monitor)
from repro_torch.core.stream.estimators import (OnlinePeriodEstimator,
                                                StreamCorrections,
                                                default_calibrations)
from repro_torch.core.stream.health import (HEALTHY, QUARANTINED, STALE,
                                            HealthPolicy, HealthTracker)
from repro_torch.core.stream.ingest import IngestCore, IngestReport
from repro_torch.core.stream.monitor import MonitorService
from repro_torch.core.stream.replay import replay
from repro_torch.core.stream.schema import SCHEMA_VERSION, SchemaError
from repro_torch.core.stream.snapshot import FleetEnergy, MonitorSnapshot
from repro_torch.core.stream.state import DeviceState, IngestBuffer
from repro_torch.core.stream.supervisor import (MonitorSupervisor,
                                                SupervisorReport)

__all__ = ["DeviceState", "IngestBuffer",
           "OnlinePeriodEstimator", "StreamCorrections",
           "default_calibrations",
           "FleetEnergy", "IngestCore", "IngestReport", "MonitorService",
           "MonitorSnapshot", "SCHEMA_VERSION", "SchemaError",
           "HEALTHY", "STALE", "QUARANTINED", "HealthPolicy",
           "HealthTracker", "CheckpointError", "MissingCheckpointError",
           "save_monitor", "restore_monitor",
           "MonitorSupervisor", "SupervisorReport", "replay"]
