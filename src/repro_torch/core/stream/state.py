"""Stacked per-device state for the streaming fleet monitor, on the card.

The counterparts of :mod:`repro.core.stream.state`: every accumulator is
one [N] (or [N, R]) tensor on the monitor's device, updated in place by
scatter writes over the devices a slab touched.

* :class:`DeviceState` — last accepted sample, running raw/corrected
  energy, registered-window energy, run-tracking state, ingestion
  counters and the drift EWMA.
* :class:`IngestBuffer` — a ring of each device's most recent samples
  ``(t, reading, running raw energy, running corrected energy)`` that
  makes any recent instant exactly reconstructible.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common import spans
from repro_torch.core.stream import schema

F64, I64 = torch.float64, torch.int64


@dataclasses.dataclass
class DeviceState:
    """Streaming accumulators, one slot per device."""

    last_t: torch.Tensor          # [N] newest accepted sample time
    last_v: torch.Tensor          # [N] newest accepted (baselined) reading
    has: torch.Tensor             # [N] device has reported at least once
    first_t: torch.Tensor         # [N] first accepted sample time
    n_samples: torch.Tensor       # [N] accepted samples
    n_dup: torch.Tensor           # [N] duplicates dropped
    n_late: torch.Tensor          # [N] out-of-order (late) samples dropped
    energy_j: torch.Tensor        # [N] ∫ raw readings dt since first sample
    energy_corr_j: torch.Tensor   # [N] ∫ corrected readings dt
    win_j: torch.Tensor           # [N] raw energy clipped to the window
    win_corr_j: torch.Tensor      # [N] corrected energy clipped to the window
    run_t: torch.Tensor           # [N] time of the last reading change
    n_changes: torch.Tensor       # [N] reading changes seen (ever)
    ewma_w: torch.Tensor          # [N] EWMA of corrected readings (drift)
    n_out: torch.Tensor           # [N] readings outside the envelope

    @classmethod
    def zeros(cls, n: int, device: torch.device) -> "DeviceState":
        def f():
            return torch.zeros(n, dtype=F64, device=device)

        def i():
            return torch.zeros(n, dtype=I64, device=device)

        return cls(last_t=f(), last_v=f(),
                   has=torch.zeros(n, dtype=torch.bool, device=device),
                   first_t=f(), n_samples=i(), n_dup=i(), n_late=i(),
                   energy_j=f(), energy_corr_j=f(), win_j=f(), win_corr_j=f(),
                   run_t=f(), n_changes=i(), ewma_w=f(), n_out=i())

    def clone(self) -> "DeviceState":
        return DeviceState(**{f.name: getattr(self, f.name).clone()
                              for f in dataclasses.fields(self)})

    def nbytes(self) -> int:
        return schema.registry_nbytes(self, schema.DEVICE_STATE_FIELDS,
                                      "DeviceState")


class IngestBuffer:
    """Ring of each device's ``slots`` most recent accepted samples.

    Writes happen once per slab and only each group's last ``slots``
    samples are written, so scatter indices never collide and a plain
    ``index_put_`` suffices.  ``slots=0`` disables the buffer (past
    queries then report not-covered).
    """

    def __init__(self, n_devices: int, slots: int, device: torch.device):
        if slots < 0:
            raise ValueError(f"ring slots must be >= 0, got {slots}")
        self.slots = int(slots)
        self.n_written = torch.zeros(n_devices, dtype=I64, device=device)
        if self.slots:
            shape = (n_devices, self.slots)
            self.t = torch.full(shape, float("inf"), dtype=F64, device=device)
            self.v = torch.zeros(shape, dtype=F64, device=device)
            self.e_raw = torch.zeros(shape, dtype=F64, device=device)
            self.e_corr = torch.zeros(shape, dtype=F64, device=device)

    def nbytes(self) -> int:
        return schema.registry_nbytes(self, schema.RING_FIELDS,
                                      "IngestBuffer",
                                      optional=schema.RING_SLOT_FIELDS)

    def write(self, dev, ordinal, group_count, t, v, e_raw, e_corr,
              u_dev, counts) -> None:
        """Append one slab's accepted samples: ``dev``/``ordinal``/
        ``group_count`` per sample [K] (device, position within its
        group, group size), ``u_dev``/``counts`` per group [U]."""
        if self.slots:
            keep = ordinal >= group_count - self.slots
            with spans.read("ingest.ring", 6):
                d, o = dev[keep], ordinal[keep]
                t, v = t[keep], v[keep]
                e_raw, e_corr = e_raw[keep], e_corr[keep]
            slot = (self.n_written[d] + o) % self.slots
            self.t.index_put_((d, slot), t)
            self.v.index_put_((d, slot), v)
            self.e_raw.index_put_((d, slot), e_raw)
            self.e_corr.index_put_((d, slot), e_corr)
        self.n_written[u_dev] += counts

    def write_grid(self, dev, t, v, e_raw, e_corr) -> None:
        """Append one rectangular slab: ``dev`` [D] distinct devices at
        the shared increasing times ``t`` [M]; ``v``/``e_raw``/``e_corr``
        are [D, M].  Only each row's last ``slots`` columns land."""
        m = t.shape[0]
        if self.slots:
            kc = min(self.slots, m)
            cols = torch.arange(m - kc, m, device=t.device)
            rows = dev[:, None].expand(dev.shape[0], kc)
            slot = (self.n_written[dev][:, None] + cols[None, :]) % self.slots
            self.t.index_put_((rows, slot), t[cols][None, :].expand_as(slot))
            self.v.index_put_((rows, slot), v[:, cols])
            self.e_raw.index_put_((rows, slot), e_raw[:, cols])
            self.e_corr.index_put_((rows, slot), e_corr[:, cols])
        self.n_written[dev] += m

    def sorted_view(self):
        """``(t, v, e_raw, e_corr)`` [N, R] oldest→newest per row, unused
        slots ``+inf``."""
        if not self.slots:
            raise RuntimeError("ring buffer disabled (slots=0)")
        r = self.slots
        start = torch.where(self.n_written >= r, self.n_written % r, 0)
        order = (start[:, None]
                 + torch.arange(r, device=start.device)[None, :]) % r
        return tuple(torch.gather(x, 1, order)
                     for x in (self.t, self.v, self.e_raw, self.e_corr))
