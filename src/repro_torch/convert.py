"""Carry the JAX package's parameters into the port, and back to numpy.

What a monitor or audit run carries are a sensor fleet's hidden
parameters, the §5 correction parameters and a monitor's online state;
the language model's weights go across with :func:`lm_params`, an
AdamW state with :func:`adamw_state`.  The
functions here take them as numpy arrays — as the reference
package (:mod:`repro`) holds them — and build the port's tensors on a
device, or turn the port's back into numpy so that the two packages can
be compared like with like.  Field names follow the reference:
``SensorBank.true_gain/true_offset/true_phase/_model_gain``, the
``StreamCorrections`` fields, and the ``state.*`` / ``ring.*`` /
``periods.*`` / ``moments.*`` / ``health.*`` keys of the reference's
checkpoint layout (``repro.core.stream.schema.pack_monitor``; a whole
checkpoint crosses through :mod:`repro_torch.core.stream.checkpoint`).
:func:`onboard_sensor` reads a reference ``OnboardSensor``'s attributes
by name; nothing of :mod:`repro` is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.core.fleet_engine import SensorBank, StreamingMoments
from repro_torch.core.ground_truth import ActivityTimeline
from repro_torch.core.sensor import OnboardSensor, SensorProfile
from repro_torch.core.stream import schema
from repro_torch.core.stream.estimators import StreamCorrections
from repro_torch.core.stream.monitor import MonitorService
from repro_torch.core.stream.state import DeviceState
from repro_torch.models import api, transformer
from repro_torch.optim.adamw import AdamWState

_RING_SLOT_FIELDS = tuple(schema.RING_SLOT_FIELDS)
_MOMENT_FIELDS = tuple(schema.MOMENT_FIELDS)


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A host copy (``.cpu()`` alone returns a view for a CPU tensor)."""
    return x.detach().cpu().numpy().copy()


def sensor_bank(profile_names: Sequence[str], true_gain: np.ndarray,
                true_offset: np.ndarray, true_phase: np.ndarray, *,
                model_gain: Optional[np.ndarray] = None, seed: int = 0,
                device: DeviceLike = "cuda") -> SensorBank:
    """A port :class:`SensorBank` over catalog ``profile_names`` whose
    hidden gain, offset, phase and (estimation rows') model gain are the
    reference bank's (``true_gain``/``true_offset``/``true_phase``/
    ``_model_gain``, [N] each; the port's own draw of the model gain when
    ``model_gain`` is None).  ``seed`` still drives the reading noise."""
    bank = SensorBank.from_catalog(list(profile_names), seed=seed,
                                   device=device)
    bank._set_hidden(*(None if x is None else torch.as_tensor(np.asarray(x))
                       for x in (true_gain, true_offset, true_phase,
                                 model_gain)))
    return bank


def timeline(edges: np.ndarray, powers: np.ndarray,
             idle_w: float) -> ActivityTimeline:
    """A port :class:`ActivityTimeline` from a reference timeline's
    ``edges``, ``powers`` and ``idle_w``."""
    return ActivityTimeline(torch.as_tensor(np.asarray(edges, np.float64)),
                            torch.as_tensor(np.asarray(powers, np.float64)),
                            float(idle_w))


def onboard_sensor(ref_sensor, device: DeviceLike = "cuda") -> OnboardSensor:
    """A port :class:`OnboardSensor` with the reference sensor's profile
    (every field), seed, host timeline and hidden gain, offset, phase and
    (estimation sensors') model gain.  The seed still drives the port's
    own reading noise and jitter."""
    host = ref_sensor.host_timeline
    sensor = OnboardSensor(
        SensorProfile(**dataclasses.asdict(ref_sensor.profile)),
        seed=ref_sensor.seed,
        host_timeline=None if host is None else timeline(
            host.edges, host.powers, host.idle_w),
        device=device)
    sensor.bank._set_hidden(*(torch.tensor([float(x)], dtype=torch.float64)
                              for x in (ref_sensor.true_gain,
                                        ref_sensor.true_offset,
                                        ref_sensor.true_phase,
                                        getattr(ref_sensor, "_model_gain",
                                                1.0))))
    return sensor


def bank_to_numpy(bank: SensorBank) -> Dict[str, np.ndarray]:
    """A port bank's hidden parameters as numpy copies, under the names
    :func:`sensor_bank` takes them."""
    return {"true_gain": _numpy(bank.true_gain),
            "true_offset": _numpy(bank.true_offset),
            "true_phase": _numpy(bank.true_phase),
            "model_gain": _numpy(bank._model_gain)}


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
    the ``state.*``, ``ring.*``, ``periods.counts``/``periods.sums``,
    ``moments.*`` and, on a health-tracked monitor, ``health.*`` entries
    of ``pack_monitor``'s arrays (``moment_labels`` names the rows of
    ``moments.*``, as the reference's manifest meta does).  Shapes must
    match the monitor's."""
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
    if core.health is not None:
        for name in schema.HEALTH_FIELDS:
            put(core.health, name, f"health.{name}")
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
    ``moments.*`` stacked over the sorted label names, and ``health.*``
    on a health-tracked monitor): the port's own pack, less its
    ``corrections.*`` and ``config.*``."""
    arrays, _ = schema.pack_monitor(monitor)
    return {k: v for k, v in arrays.items()
            if k.split(".")[0] not in ("corrections", "config")}


def _from_numpy(x) -> torch.Tensor:
    """A tensor of ``x``'s values and type; numpy's ``bfloat16`` (the
    ``ml_dtypes`` type JAX hands out) goes across bit for bit."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def lm_params(ref_params: Mapping, cfg: ArchConfig,
              device: DeviceLike = "cuda") -> Dict:
    """The port's parameter tree for ``cfg`` from a reference tree
    (``repro.models.api.init_params``'s, its leaves as numpy arrays; a
    decoder-only or an encoder–decoder tree, as ``api.param_specs``
    lays it out): the same nested keys, every leaf's values, shape and
    type kept, the MoE experts with their padding experts (``[Ep, ...]``,
    ``Ep = cfg.n_experts_padded``; the router keeps its ``E`` columns).
    Raises if a leaf is missing, extra, or of another shape or type: a
    tree whose experts are not padded is refused."""
    dev = resolve_device(device)
    specs = api.param_specs(cfg)
    want = {path for path, _ in transformer.leaves(specs)}
    have = {path for path, _ in transformer.leaves(dict(ref_params))}
    if want != have:
        raise ValueError(f"lm_params: reference tree differs from the "
                         f"port's: missing {sorted(want - have)}, extra "
                         f"{sorted(have - want)}")

    def leaf(path, spec):
        x = ref_params
        for k in path:
            x = x[k]
        t = _from_numpy(x)
        if tuple(t.shape) != spec.shape or t.dtype != spec.dtype:
            raise ValueError(f"lm_params: {'/'.join(path)} is {t.dtype}"
                             f"{tuple(t.shape)}, the port's {spec.dtype}"
                             f"{spec.shape}")
        return t.to(dev)
    return transformer.map_tree(leaf, specs)


def adamw_state(ref_state, device: DeviceLike = "cuda") -> AdamWState:
    """The port's :class:`~repro_torch.optim.adamw.AdamWState` from a
    reference ``AdamWState`` (its ``count``, ``mu`` and ``nu``, leaves as
    numpy arrays or anything ``np.asarray`` takes): the same trees of
    f32 moments and the int32 step count, on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: _from_numpy(x).to(dev), AdamWState(
        count=ref_state.count, mu=ref_state.mu, nu=ref_state.nu))
