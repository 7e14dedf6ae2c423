"""Hand-written CUDA kernels of the port, with their wrappers.

* :mod:`.stream_ingest` — the monitor's general slab kernel;
* :mod:`.stream_ingest_grid` — its rectangular clean-slab fast path.

Each wrapper runs the plain PyTorch version
(:mod:`repro_torch.engine_backend.torch_backend`) for CPU tensors and
launches its kernel for CUDA tensors, counting launches in its
``launches`` attribute.  :mod:`._build` compiles the sources in
``csrc/`` on first use.
"""
