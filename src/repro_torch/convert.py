"""Carry the JAX package's parameters into the port, and back to numpy.

This system has no model weights; what a run carries are a sensor fleet's
hidden parameters, the §5 correction parameters and a monitor's online
state.  The functions here take them as numpy arrays — as the reference
package (:mod:`repro`) holds them — and build the port's tensors on a
device, or turn the port's back into numpy so that the two packages can
be compared like with like.  Field names follow the reference:
``SensorBank.true_gain/true_offset/true_phase``, the
``StreamCorrections`` fields, and the ``state.*`` / ``ring.*`` /
``periods.*`` / ``moments.*`` keys of the reference's checkpoint layout
(``repro.core.stream.schema.pack_monitor``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike
from repro_torch.core.fleet_engine import SensorBank, StreamingMoments
from repro_torch.core.stream.estimators import StreamCorrections
from repro_torch.core.stream.monitor import MonitorService
from repro_torch.core.stream.state import DeviceState

_RING_SLOT_FIELDS = ("t", "v", "e_raw", "e_corr")
_MOMENT_FIELDS = ("n", "mean", "m2", "mean_abs", "max_abs")


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A host copy (``.cpu()`` alone returns a view for a CPU tensor)."""
    return x.detach().cpu().numpy().copy()


def sensor_bank(profile_names: Sequence[str], true_gain: np.ndarray,
                true_offset: np.ndarray, true_phase: np.ndarray, *,
                seed: int = 0, device: DeviceLike = "cuda") -> SensorBank:
    """A port :class:`SensorBank` over catalog ``profile_names`` whose
    hidden gain, offset and phase are the reference bank's
    (``true_gain``/``true_offset``/``true_phase``, [N] each).  ``seed``
    still drives the reading noise."""
    bank = SensorBank.from_catalog(list(profile_names), seed=seed,
                                   device=device)
    bank._set_hidden(torch.as_tensor(np.asarray(true_gain)),
                     torch.as_tensor(np.asarray(true_offset)),
                     torch.as_tensor(np.asarray(true_phase)))
    return bank


def stream_corrections(fields: Mapping[str, np.ndarray], *,
                       device: DeviceLike = "cuda") -> StreamCorrections:
    """A port :class:`StreamCorrections` from the reference's fields
    (``gain``, ``offset_w``, ``time_shift_s``, ``baseline_w``,
    ``ref_period_s``, ``calibrated``), e.g. ``dataclasses.asdict`` of a
    reference ``StreamCorrections``."""
    out = {}
    for f in dataclasses.fields(StreamCorrections):
        a = np.asarray(fields[f.name])
        dtype = torch.bool if f.name == "calibrated" else torch.float64
        out[f.name] = torch.as_tensor(a, dtype=dtype)
    return StreamCorrections(**out).to(device)


def corrections_to_numpy(corr: StreamCorrections) -> Dict[str, np.ndarray]:
    """The inverse of :func:`stream_corrections`."""
    return {f.name: _numpy(getattr(corr, f.name))
            for f in dataclasses.fields(StreamCorrections)}


def load_monitor_state(monitor: MonitorService,
                       arrays: Mapping[str, np.ndarray],
                       moment_labels: Sequence[str] = ()) -> None:
    """Overwrite ``monitor``'s online state with a reference monitor's:
    the ``state.*``, ``ring.*``, ``periods.counts``/``periods.sums`` and
    ``moments.*`` entries of ``pack_monitor``'s arrays (``moment_labels``
    names the rows of ``moments.*``, as the reference's manifest meta
    does).  Shapes must match the monitor's."""
    core = monitor.core
    dev = core.device

    def put(obj, name: str, key: str) -> None:
        cur = getattr(obj, name)
        new = torch.as_tensor(np.asarray(arrays[key]), dtype=cur.dtype,
                              device=dev)
        if new.shape != cur.shape:
            raise ValueError(f"{key}: shape {tuple(new.shape)}, monitor "
                             f"has {tuple(cur.shape)}")
        setattr(obj, name, new.clone())

    for f in dataclasses.fields(DeviceState):
        put(core.state, f.name, f"state.{f.name}")
    put(core.ring, "n_written", "ring.n_written")
    if core.ring.slots:
        for name in _RING_SLOT_FIELDS:
            put(core.ring, name, f"ring.{name}")
    put(core.periods, "counts", "periods.counts")
    put(core.periods, "sums", "periods.sums")
    core._moments = {}
    for i, label in enumerate(moment_labels):
        sm = StreamingMoments()
        sm.n = int(arrays["moments.n"][i])
        for name in _MOMENT_FIELDS[1:]:
            setattr(sm, name, float(arrays[f"moments.{name}"][i]))
        core._moments[str(label)] = sm
    core.epoch += 1


def monitor_arrays(monitor: MonitorService) -> Dict[str, np.ndarray]:
    """A port monitor's online state as numpy copies under the keys of the
    reference's ``pack_monitor`` (``state.*``, ``ring.*``, ``periods.*``,
    ``moments.*`` stacked over the sorted label names)."""
    core = monitor.core
    out = {f"state.{f.name}": _numpy(getattr(core.state, f.name))
           for f in dataclasses.fields(DeviceState)}
    out["ring.n_written"] = _numpy(core.ring.n_written)
    if core.ring.slots:
        for name in _RING_SLOT_FIELDS:
            out[f"ring.{name}"] = _numpy(getattr(core.ring, name))
    for name in ("edges", "counts", "sums"):
        out[f"periods.{name}"] = _numpy(getattr(core.periods, name))
    labels = sorted(core._moments)
    for name in _MOMENT_FIELDS:
        dtype = np.int64 if name == "n" else np.float64
        out[f"moments.{name}"] = np.array(
            [getattr(core._moments[lb], name) for lb in labels], dtype=dtype)
    return out
