"""The on-board power sensor: sensor classes (one row of the paper's
Fig. 14) and the scalar sensor an nvidia-smi user polls.

The counterpart of :mod:`repro.core.sensor`.  :class:`OnboardSensor` is a
one-device view of a :class:`~repro_torch.core.fleet_engine.SensorBank`,
so the scalar sensor runs the bank's transients (the CUDA ``log_filter``
kernel for Kepler/Maxwell on the card) and draws the bank's keyed
reading noise: ``OnboardSensor(profile, seed)`` is
``SensorBank([profile], seed=seed)``, and ``bank.scalar_reference(i)``
reads what row ``i`` of ``bank`` reads, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import torch

from repro_torch._device import DeviceLike
from repro_torch.core.ground_truth import ActivityTimeline

if TYPE_CHECKING:  # fleet_engine imports this module
    from repro_torch.core.fleet_engine import SensorBank

F64 = torch.float64


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


class OnboardSensor:
    """A concrete sensor with hidden per-device parameters, on ``device``.

    Usage::

        sensor = OnboardSensor(profile, seed=7)
        sensor.attach(timeline, t_end=10.0)      # device activity
        watts = sensor.query(t)                  # what nvidia-smi would print
    """

    def __init__(self, profile: SensorProfile, seed: int = 0,
                 host_timeline: Optional[ActivityTimeline] = None, *,
                 device: DeviceLike = "cuda"):
        from repro_torch.core.fleet_engine import SensorBank
        self._bank = SensorBank([profile], seed=seed,
                                host_timeline=host_timeline, device=device)

    @classmethod
    def of_bank(cls, bank: "SensorBank") -> "OnboardSensor":
        """The scalar sensor over a one-device bank (not copied)."""
        if bank.n_devices != 1:
            raise ValueError(f"a scalar sensor needs a one-device bank, got "
                             f"{bank.n_devices} devices")
        sensor = object.__new__(cls)
        sensor._bank = bank
        return sensor

    @property
    def bank(self) -> "SensorBank":
        return self._bank

    @property
    def profile(self) -> SensorProfile:
        return self._bank.profiles[0]

    @property
    def seed(self) -> int:
        return self._bank.seed

    @property
    def host_timeline(self) -> Optional[ActivityTimeline]:
        return self._bank.host_timeline

    @property
    def device(self) -> torch.device:
        return self._bank.device

    # hidden-truth accessors for closed-loop validation only
    @property
    def true_gain(self) -> float:
        return float(self._bank.true_gain[0])

    @property
    def true_offset(self) -> float:
        return float(self._bank.true_offset[0])

    @property
    def true_phase(self) -> float:
        return float(self._bank.true_phase[0])

    # -- simulation -------------------------------------------------------
    def attach(self, timeline: ActivityTimeline,
               t_end: Optional[float] = None, t_start: float = 0.0) -> None:
        """Precompute the published-reading schedule for an activity
        trace."""
        self._bank.attach(timeline, t_end=t_end, t_start=t_start)

    # -- query API (all an nvidia-smi user gets) --------------------------
    def query(self, t) -> torch.Tensor:
        """Latest published reading at wall-clock time(s) ``t`` (any shape),
        on the sensor's device."""
        t = torch.as_tensor(t, dtype=F64, device=self.device)
        return self._bank.query(t.reshape(-1))[0].reshape(t.shape)

    def poll(self, t0: float, t1: float, period_s: float = 0.001,
             jitter_s: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Poll like ``nvidia-smi --query-gpu=power.draw -lms <period>``:
        ``floor((t1 - t0) / period_s)`` instants from ``t0``, each late by
        a U[0, jitter_s) draw (then sorted) when ``jitter_s > 0``.
        Returns ``(query_times, readings)``."""
        ts, vals = self._bank.poll(t0, t1, period_s, jitter_s)
        return (ts if ts.ndim == 1 else ts[0]), vals[0]


def _sum_timelines(a: ActivityTimeline,
                   b: ActivityTimeline) -> ActivityTimeline:
    """Pointwise sum of two piecewise-constant timelines."""
    edges = torch.unique(torch.cat([a.edges, b.edges]), sorted=True)
    mids = 0.5 * (edges[:-1] + edges[1:])
    return ActivityTimeline(edges, a.power_at(mids) + b.power_at(mids),
                            idle_w=a.idle_w + b.idle_w)
