"""Core of the port: sensors, timelines, calibration, the sensor bank,
the mixed fleet's scenarios, energy accounting and the streaming monitor
(:mod:`.stream`)."""
from repro_torch.core.ledger import EnergyLedger, LedgerEntry
from repro_torch.core.telemetry import (FleetLedger, FleetSummary,
                                        datacenter_projection)

__all__ = ["EnergyLedger", "LedgerEntry", "FleetLedger", "FleetSummary",
           "datacenter_projection"]
