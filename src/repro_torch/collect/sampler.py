"""Live samplers: the NVML-style polling interface behind the collector.

The counterpart of :mod:`repro.collect.sampler`.  A :class:`Sampler`
answers "one poll of every visible device, now" as a
:class:`~repro_torch.collect.wire.SampleBatch`.  Two implementations:

* :class:`SimulatedSampler` — over a
  :class:`~repro_torch.core.fleet_engine.SensorBank`, so the whole
  collector path (sampler → registry → assembler → monitor) runs without
  hardware; its output equals the simulation-fed
  :func:`~repro_torch.core.stream.replay.replay` bitwise.
* :class:`NvmlSampler` — real GPUs over ``pynvml``, imported lazily so
  the module imports on hosts without the NVIDIA stack.
"""
from __future__ import annotations

from typing import Iterator, Optional, Protocol, Sequence

import numpy as np

from repro_torch.collect.wire import SampleBatch


class Sampler(Protocol):
    """One poll of every visible device (NVML-style)."""

    def sample(self) -> SampleBatch:
        """Read every device once; timestamps are the sampler's clock."""
        ...


class SimulatedSampler:
    """Poll a :class:`~repro_torch.core.fleet_engine.SensorBank` like a
    daemon.

    Each :meth:`sample` reads all N sensors at the current clock
    (``SensorBank.query`` on the bank's device, the readings copied to the
    host as a wire batch would carry them) and advances the clock by
    ``period_s``: the uniform grid ``SensorBank.iter_poll_slabs`` emits.
    Synthetic uuids are ``{prefix}{seed + row:08x}`` from the bank's seed
    and each device's fleet row, which are the reference's uuids for a
    bank of per-device seeds ``seed + row``.
    """

    def __init__(self, bank, t0: float = 0.0, period_s: float = 0.001,
                 uuid_prefix: str = "GPU-SIM-",
                 uuids: Optional[Sequence[str]] = None):
        if period_s <= 0.0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        self.bank = bank
        self.t0 = float(t0)
        self.period_s = float(period_s)
        n = bank.n_devices
        if uuids is None:
            self.uuids = np.asarray(
                [f"{uuid_prefix}{int(s) & 0xFFFFFFFF:08x}"
                 for s in bank.seed + np.asarray(bank._rows)], dtype=object)
        else:
            self.uuids = np.asarray(list(uuids), dtype=object)
        if self.uuids.shape != (n,):
            raise ValueError(f"need {n} uuids, got {self.uuids.shape}")
        if len(set(self.uuids)) != n:
            raise ValueError("sampler uuids must be unique")
        self._k = 0          # polls taken so far

    @property
    def t_next(self) -> float:
        """The clock instant the next :meth:`sample` will read at."""
        return self.t0 + self.period_s * self._k

    def sample(self) -> SampleBatch:
        t = self.t_next
        vals = self.bank.query(t).cpu().numpy()
        self._k += 1
        n = self.bank.n_devices
        return SampleBatch(uuid=self.uuids.copy(),
                           t=np.full(n, t),
                           power_w=vals,
                           util=np.full(n, np.nan))

    def run(self, n_polls: int) -> Iterator[SampleBatch]:
        """Take ``n_polls`` consecutive samples."""
        for _ in range(int(n_polls)):
            yield self.sample()


class NvmlSampler:
    """Poll real GPUs through NVML (``pynvml``), lazily imported.

    Construction raises a clear RuntimeError when the NVIDIA stack is
    absent, so everything else in :mod:`repro_torch.collect` works on a
    host without it.
    """

    def __init__(self):
        try:
            import pynvml
        except ImportError as e:
            raise RuntimeError(
                "NvmlSampler needs the 'pynvml' package and the NVIDIA "
                "management library; elsewhere use SimulatedSampler or "
                "replay a recorded log") from e
        self._nvml = pynvml
        pynvml.nvmlInit()
        n = pynvml.nvmlDeviceGetCount()
        self._handles = [pynvml.nvmlDeviceGetHandleByIndex(i)
                         for i in range(n)]
        self.uuids = np.asarray(
            [_as_str(pynvml.nvmlDeviceGetUUID(h)) for h in self._handles],
            dtype=object)

    def sample(self) -> SampleBatch:
        import time
        nvml = self._nvml
        t = time.time()
        n = len(self._handles)
        power = np.full(n, np.nan)
        util = np.full(n, np.nan)
        for i, h in enumerate(self._handles):
            try:
                power[i] = nvml.nvmlDeviceGetPowerUsage(h) * 1e-3  # mW → W
            except nvml.NVMLError:
                pass                      # [N/A]: stays NaN, counted
            try:                          # downstream by the monitor
                util[i] = nvml.nvmlDeviceGetUtilizationRates(h).gpu
            except nvml.NVMLError:
                pass
        return SampleBatch(uuid=self.uuids.copy(), t=np.full(n, t),
                           power_w=power, util=util)

    def close(self) -> None:
        self._nvml.nvmlShutdown()


def _as_str(x) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)
