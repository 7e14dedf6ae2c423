"""Optimizer of the port's training step: AdamW (:mod:`.adamw`) and int8
gradient compression with error feedback (:mod:`.compress`)."""
