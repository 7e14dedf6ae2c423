"""Checkpoint storage of the port (see :mod:`.checkpoint`)."""
