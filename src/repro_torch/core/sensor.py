"""Sensor-class descriptions (one row of the paper's Fig. 14).

The counterpart of the data half of :mod:`repro.core.sensor`: the
scalar ``OnboardSensor`` reference device is not part of the port; the
batched :class:`~repro_torch.core.fleet_engine.SensorBank` is.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SensorProfile:
    """Static description of a sensor class.

    A reading is published every ``update_period_s``; it is
    ``gain · boxcar_mean(P, window_s) + offset`` plus jitter, quantised to
    ``quantum_w`` (``window_s=None`` marks a logarithmic transient).
    """

    name: str
    update_period_s: float = 0.100
    window_s: Optional[float] = 0.025       # None => logarithmic transient
    transient: str = "boxcar"               # boxcar | logarithmic | estimation
    tau_s: float = 0.25                     # filter constant for logarithmic
    gain_tol: float = 0.05                  # ±5 % shunt tolerance (Fig. 9)
    offset_tol_w: float = 3.0               # additive component of the error
    quantum_w: float = 0.01                 # reporting resolution (watts)
    noise_w: float = 0.15                   # reading jitter
    scope: str = "chip"                     # chip | module  (GH200 §6)
    supported: bool = True                  # Fermi 1.0: no power readings
    model_error: float = 0.0                # estimation-based extra error

    @property
    def sampled_fraction(self) -> float:
        """Fraction of runtime the sensor actually observes (the paper's
        headline '25 %' for A100/H100)."""
        if self.window_s is None:
            return 1.0
        return min(1.0, self.window_s / self.update_period_s)


class SensorUnsupported(RuntimeError):
    pass
