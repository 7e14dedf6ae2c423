"""Per-device calibration records (the part of :mod:`repro.core.calibrate`
the streaming monitor needs): :class:`CalibrationRecord` and the
:func:`nominal_record` recipe."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CalibrationRecord:
    device_id: str
    profile_name: str
    update_period_s: float
    window_s: Optional[float]          # None => logarithmic-transient class
    transient_kind: str                # instant | linear | logarithmic
    rise_time_s: float
    gain: Optional[float] = None       # None when no ground-truth meter
    offset_w: Optional[float] = None
    r2: Optional[float] = None
    sampled_fraction: float = 1.0
    created_at: float = 0.0
    fitted_at: Optional[float] = None  # when the characterisation ran
    source: str = ""                   # protocol/tool that fitted it
    note: str = ""                     # free-form operator annotation

    @property
    def correction_gain(self) -> float:
        """The gain to invert when applying this calibration (1.0 when
        the record was built without a ground-truth meter)."""
        return self.gain if self.gain else 1.0

    @property
    def correction_offset_w(self) -> float:
        return self.offset_w or 0.0

    @property
    def time_shift_s(self) -> float:
        """The §5 re-synchronisation shift: a reading at ``t`` covers the
        trailing averaging window, so reported timestamps move back by
        the window (or one update period for window-less transients)."""
        return self.window_s if self.window_s else self.update_period_s


def nominal_record(device_id: str, profile) -> CalibrationRecord:
    """A synthetic record from a profile's *nominal* catalog parameters:
    no measured gain/offset (correction inverts nothing), rise time 2.5
    update periods."""
    return CalibrationRecord(
        device_id, profile.name, profile.update_period_s,
        profile.window_s, "instant", 2.5 * profile.update_period_s,
        sampled_fraction=profile.sampled_fraction)
