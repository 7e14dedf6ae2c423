"""Per-device calibration records and a persistent store.

The counterpart of :mod:`repro.core.calibrate`: never trust a power
sensor you have not characterised.  :class:`CalibrationRecord` (with its
JSON form, which tolerates schema drift), the :func:`nominal_record`
recipe, :func:`record_from_characterisation` and
:class:`CalibrationStore`, which runs the port's
:func:`repro_torch.core.microbench.characterise` once per device and
keeps the record as a JSON file.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger(__name__)


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

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "CalibrationRecord":
        """Load a persisted record, tolerating schema drift.

        Stores outlive the code that wrote them: a record persisted
        before a field was added (the new field falls back to its
        dataclass default), or after one was removed (the stale key is
        dropped), must still load.  Only fields without defaults are
        required.
        """
        data = json.loads(s)
        if not isinstance(data, dict):
            raise ValueError("calibration record must be a JSON object, "
                             f"got {type(data).__name__}")
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - set(fields))
        if unknown:
            log.info("dropping unknown calibration fields: %s",
                     ",".join(unknown))
        required = [n for n, f in fields.items()
                    if f.default is dataclasses.MISSING
                    and f.default_factory is dataclasses.MISSING]
        missing = sorted(set(required) - set(data))
        if missing:
            raise ValueError("calibration record missing required "
                             f"field(s): {', '.join(missing)}")
        return cls(**{k: v for k, v in data.items() if k in fields})


def nominal_record(device_id: str, profile) -> CalibrationRecord:
    """A synthetic record from a profile's *nominal* catalog parameters:
    no measured gain/offset (correction inverts nothing), rise time 2.5
    update periods."""
    return CalibrationRecord(
        device_id, profile.name, profile.update_period_s,
        profile.window_s, "instant", 2.5 * profile.update_period_s,
        sampled_fraction=profile.sampled_fraction)


def record_from_characterisation(device_id: str, profile_name: str,
                                 result) -> CalibrationRecord:
    """Build a record from a
    :class:`~repro_torch.core.microbench.CharacterisationResult`."""
    return CalibrationRecord(
        device_id=device_id,
        profile_name=profile_name,
        update_period_s=result.update_period_s,
        window_s=result.window_s,
        transient_kind=result.transient.kind,
        rise_time_s=(result.transient.rise_time_s
                     if result.transient.kind != "instant"
                     else result.update_period_s * 2.5),
        gain=result.gain,
        offset_w=result.offset_w,
        r2=result.r2,
        sampled_fraction=result.sampled_fraction,
        created_at=time.time(),
        fitted_at=time.time(),
        source="microbench.characterise",
    )


class CalibrationStore:
    """JSON-file-backed store, one file per device id."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._cache: Dict[str, CalibrationRecord] = {}

    def _path(self, device_id: str) -> str:
        safe = device_id.replace("/", "_")
        return os.path.join(self.root, f"{safe}.json")

    def get(self, device_id: str) -> Optional[CalibrationRecord]:
        if device_id in self._cache:
            return self._cache[device_id]
        p = self._path(device_id)
        if os.path.exists(p):
            with open(p) as f:
                rec = CalibrationRecord.from_json(f.read())
            self._cache[device_id] = rec
            return rec
        return None

    def put(self, rec: CalibrationRecord) -> None:
        self._cache[rec.device_id] = rec
        with open(self._path(rec.device_id), "w") as f:
            f.write(rec.to_json())

    def get_or_characterise(self, device_id: str, sensor, meter=None,
                            profile_name: str = "") -> CalibrationRecord:
        """The stored record of ``device_id``, else characterise
        ``sensor`` (with ``meter`` when given), store and return it."""
        rec = self.get(device_id)
        if rec is not None:
            return rec
        from repro_torch.core.microbench import characterise
        log.info("characterising sensor %s", device_id)
        result = characterise(sensor, meter)
        rec = record_from_characterisation(
            device_id, profile_name or sensor.profile.name, result)
        self.put(rec)
        return rec
