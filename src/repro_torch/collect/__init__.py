"""Live collector: real telemetry → the streaming monitor on the card.

The counterpart of :mod:`repro.collect`.  Layers, importable à la carte:

* :mod:`repro_torch.collect.wire` — wire-format parsers/writers with
  drop-and-count accounting (:class:`WireCounters`) and the columnar
  :class:`SampleBatch` interchange type (host numpy);
* :mod:`repro_torch.collect.registry` — :class:`DeviceRegistry`, the
  gpu_uuid → dense-device-id mapping with hot-add / frozen-fleet
  policies;
* :mod:`repro_torch.collect.sampler` — the NVML-style :class:`Sampler`
  protocol: :class:`SimulatedSampler` over a ``SensorBank`` and the
  lazily imported :class:`NvmlSampler`;
* :mod:`repro_torch.collect.assembler` — :class:`SlabAssembler`
  (fixed-size ingest slabs) and :class:`CollectorPipeline` (registry,
  calibration store, a lazy monitor on the card, hot growth);
* :mod:`repro_torch.collect.cli` — ``python -m repro_torch.collect
  replay`` / ``calibrate ...``.
"""
from repro_torch.collect.assembler import CollectorPipeline, SlabAssembler
from repro_torch.collect.registry import DeviceRegistry, UnknownDeviceError
from repro_torch.collect.sampler import (NvmlSampler, Sampler,
                                         SimulatedSampler)
from repro_torch.collect.wire import (SampleBatch, WireCounters,
                                      format_daemon, format_query_gpu,
                                      iter_batches, parse_daemon, parse_log,
                                      parse_query_gpu, sniff_format)

__all__ = [
    "CollectorPipeline", "SlabAssembler",
    "DeviceRegistry", "UnknownDeviceError",
    "NvmlSampler", "Sampler", "SimulatedSampler",
    "SampleBatch", "WireCounters",
    "format_daemon", "format_query_gpu",
    "iter_batches", "parse_daemon", "parse_log", "parse_query_gpu",
    "sniff_format",
]
