"""Per-run energy ledger: checkpoint-persistable energy accounting.

The counterpart of :mod:`repro.core.ledger`.  Each training or serving
step appends one entry with the naive sensor integral, the corrected
estimate and an uncertainty; the ledger survives a checkpoint and
restart as JSON, in the reference's layout.  Plain Python: no tensors.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List


@dataclasses.dataclass
class LedgerEntry:
    step: int
    t0: float
    t1: float
    naive_j: float
    corrected_j: float
    sigma_j: float

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class EnergyLedger:
    device_id: str = "device0"
    entries: List[LedgerEntry] = dataclasses.field(default_factory=list)

    def append(self, step: int, t0: float, t1: float, naive_j: float,
               corrected_j: float, sigma_j: float = 0.0) -> None:
        self.entries.append(LedgerEntry(step, t0, t1, naive_j,
                                        corrected_j, sigma_j))

    @property
    def total_naive_j(self) -> float:
        return float(sum(e.naive_j for e in self.entries))

    @property
    def total_corrected_j(self) -> float:
        return float(sum(e.corrected_j for e in self.entries))

    @property
    def total_sigma_j(self) -> float:
        # per-step sigmas from one device share the same gain error, so
        # they are correlated: added linearly, not in quadrature
        return float(sum(e.sigma_j for e in self.entries))

    @property
    def total_duration_s(self) -> float:
        return float(sum(e.duration_s for e in self.entries))

    def mean_power_w(self) -> float:
        d = self.total_duration_s
        return self.total_corrected_j / d if d > 0 else 0.0

    # -- persistence -------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "device_id": self.device_id,
            "entries": [dataclasses.asdict(e) for e in self.entries],
        })

    @classmethod
    def from_json(cls, s: str) -> "EnergyLedger":
        """The ledger ``to_json`` wrote.  An entry with a field the
        dataclass lacks, or without one it needs, raises ``TypeError``
        as the reference's does (no field has a default)."""
        d = json.loads(s)
        led = cls(device_id=d["device_id"])
        led.entries = [LedgerEntry(**e) for e in d["entries"]]
        return led

    def summary(self) -> dict:
        return {
            "device_id": self.device_id,
            "steps": len(self.entries),
            "total_naive_j": self.total_naive_j,
            "total_corrected_j": self.total_corrected_j,
            "total_sigma_j": self.total_sigma_j,
            "mean_power_w": self.mean_power_w(),
            "naive_vs_corrected": (
                (self.total_naive_j - self.total_corrected_j)
                / self.total_corrected_j if self.total_corrected_j else 0.0),
        }
