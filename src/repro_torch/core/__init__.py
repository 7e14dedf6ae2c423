"""Core of the port: sensors, timelines, calibration, the sensor bank,
the mixed fleet's scenarios, energy accounting and the streaming monitor
(:mod:`.stream`), and the activity model that turns a training step into
a power timeline (:mod:`.activity`).

Public API (the reference's, on the card by default)::

    from repro_torch.core import profiles
    sensor = OnboardSensor(profiles.get("a100"), seed=0)
    calib  = CalibrationStore(".calib").get_or_characterise("dev0", sensor)
    est    = measure_good_practice(sensor, workload, calib)
"""
from repro_torch.core.activity import (ChipPowerModel, StepActivity,
                                       phase_timeline, steps_timeline)
from repro_torch.core.calibrate import CalibrationRecord, CalibrationStore
from repro_torch.core.fleet_engine import (FleetAuditResult, SensorBank,
                                           fleet_audit)
from repro_torch.core.ground_truth import (ActivityTimeline,
                                           GroundTruthMeter, TimelineBank,
                                           from_segments)
from repro_torch.core.ledger import EnergyLedger, LedgerEntry
from repro_torch.core.meter import (BatchedEnergyEstimate, EnergyEstimate,
                                    GoodPracticeConfig, ModuleScopeError,
                                    Workload, WorkloadSet, compare_protocols,
                                    measure_good_practice,
                                    measure_good_practice_batch,
                                    measure_naive, measure_naive_batch)
from repro_torch.core.microbench import (CharacterisationResult,
                                         characterise,
                                         estimate_boxcar_window,
                                         estimate_steady_state,
                                         estimate_update_period,
                                         measure_transient)
from repro_torch.core.sensor import (OnboardSensor, SensorProfile,
                                     SensorUnsupported)
from repro_torch.core.stream import (MonitorService, StreamCorrections,
                                     replay, stream_fleet)
from repro_torch.core.telemetry import (FleetLedger, FleetSummary,
                                        datacenter_projection)

__all__ = [
    "ActivityTimeline", "GroundTruthMeter", "TimelineBank", "from_segments",
    "OnboardSensor", "SensorProfile", "SensorUnsupported",
    "CalibrationRecord", "CalibrationStore",
    "CharacterisationResult", "characterise", "estimate_update_period",
    "measure_transient", "estimate_steady_state", "estimate_boxcar_window",
    "Workload", "WorkloadSet", "GoodPracticeConfig", "EnergyEstimate",
    "ModuleScopeError",
    "measure_naive", "measure_good_practice", "compare_protocols",
    "SensorBank", "FleetAuditResult", "fleet_audit",
    "BatchedEnergyEstimate", "measure_naive_batch",
    "measure_good_practice_batch",
    "EnergyLedger", "LedgerEntry", "FleetLedger", "FleetSummary",
    "datacenter_projection",
    "MonitorService", "StreamCorrections", "replay", "stream_fleet",
    "ChipPowerModel", "StepActivity", "phase_timeline", "steps_timeline",
]
