"""Hand-written CUDA kernels of the port, with their wrappers.

* :mod:`.stream_ingest` — the monitor's general slab kernel;
* :mod:`.stream_ingest_grid` — its rectangular clean-slab fast path;
* :mod:`.log_filter` — the Kepler/Maxwell sensor filter of the fleet
  audit's sensor simulation;
* :mod:`.step_integrate` — the §5 protocol's integral of a polled
  reading series over a window;
* :mod:`.fma_chain` — the paper's benchmark load (Listing 1), the card's
  own power load.

Each wrapper runs the plain PyTorch version
(:mod:`repro_torch.engine_backend.torch_backend`) for CPU tensors and
launches its kernel for CUDA tensors, counting launches in its
``launches`` attribute.  :mod:`._build` compiles the sources in
``csrc/`` on first use.
"""
