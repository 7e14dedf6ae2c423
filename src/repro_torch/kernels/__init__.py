"""Hand-written CUDA kernels of the port, with their wrappers.

* :mod:`.stream_ingest` — the monitor's general slab kernel;
* :mod:`.stream_ingest_grid` — its rectangular clean-slab fast path;
* :mod:`.stream_group` — the general path's grouping of a flat slab by
  device (no TPU kernel: the reference sorts with ``np.lexsort``);
* :mod:`.log_filter` — the Kepler/Maxwell sensor filter of the fleet
  audit's sensor simulation;
* :mod:`.step_integrate` — the §5 protocol's integral of a polled
  reading series over a window;
* :mod:`.fma_chain` — the paper's benchmark load (Listing 1), the card's
  own power load;
* :mod:`.rglru_scan` — the RG-LRU linear recurrence of recurrentgemma's
  recurrent blocks;
* :mod:`.flash_attention` — forward attention with an online softmax, of
  its local-attention blocks.

Each wrapper runs the plain PyTorch version
(:mod:`repro_torch.engine_backend.torch_backend`; for the language
model's two, the plain version beside the wrapper and
:func:`repro_torch.models.layers.blocked_attention`) for CPU tensors and
launches its kernel for CUDA tensors, counting launches in its
``launches`` attribute.  :mod:`._build` compiles the sources in
``csrc/`` on first use.
"""
