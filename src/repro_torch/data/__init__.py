"""Data pipeline of the port's training loop (:mod:`.pipeline`)."""
