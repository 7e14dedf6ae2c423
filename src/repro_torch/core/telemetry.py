"""Fleet-level energy telemetry constants (the part of
:mod:`repro.core.telemetry` the fleet audit reads)."""

#: per-device relative energy uncertainty of an uncalibrated sensor: the
#: ±5 % shunt-resistor tolerance (paper §6)
SHUNT_TOLERANCE = 0.05
