"""Core of the port: sensors, timelines, calibration, the sensor bank,
the mixed fleet's scenarios, energy accounting and the streaming monitor
(:mod:`.stream`), and the activity model that turns a training step into
a power timeline (:mod:`.activity`)."""
from repro_torch.core.activity import (ChipPowerModel, StepActivity,
                                       phase_timeline, steps_timeline)
from repro_torch.core.ledger import EnergyLedger, LedgerEntry
from repro_torch.core.telemetry import (FleetLedger, FleetSummary,
                                        datacenter_projection)

__all__ = ["ChipPowerModel", "StepActivity", "phase_timeline",
           "steps_timeline", "EnergyLedger", "LedgerEntry", "FleetLedger",
           "FleetSummary", "datacenter_projection"]
