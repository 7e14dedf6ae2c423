"""Shared helpers of the port (its own copy of :mod:`repro.common`'s
config base)."""
