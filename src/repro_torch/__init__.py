"""PyTorch/CUDA port of the streaming fleet monitor.

A second package beside :mod:`repro` (the JAX reference, which it never
imports).  The main path is the live monitor: poll samples from a
:class:`~repro_torch.core.fleet_engine.SensorBank` →
:class:`~repro_torch.core.stream.ingest.IngestCore` (``ingest`` /
``ingest_grid``) → :class:`~repro_torch.core.stream.snapshot.MonitorSnapshot`
→ :class:`~repro_torch.serve.monitor_service.MonitorQueryService`.  State
lives on the card between slabs; the two ingest hot loops are hand-written
CUDA kernels (:mod:`repro_torch.kernels`).

Every entry point takes ``device=`` and defaults to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions (what the CPU tests do).
"""
