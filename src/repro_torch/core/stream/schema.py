"""Versioned (de)serialization schema for the streaming monitor's state.

The counterpart of :mod:`repro.core.stream.schema`, with the port's own
copy of its registries.  Everything a live monitor accumulates — the
:class:`~.state.DeviceState` tensors, the ring, the period histograms,
the per-label reading moments, the health machine — has one flat
representation, declared here as ``{field: dtype kind}`` registries
(numpy's kind codes: ``f8``, ``i8``, ``i1``, ``b1``).  Two consumers
share it:

* checkpointing (:mod:`.checkpoint`) packs the registry walk into the
  reference's manifest + ``.npy`` layout and unpacks it on restore, so a
  checkpoint written by either package restores in the other;
* memory reporting (``MonitorService.nbytes()``) sums the same walk.

The registries are closed: a tensor attribute added to the state without
a schema bump fails the first ``nbytes()`` or checkpoint that touches it.

This module imports nothing of the rest of the stream package at module
scope (the stream modules import it); :func:`unpack_monitor` resolves its
classes when called.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

#: Bump whenever a registry below changes shape or meaning.  Restores
#: refuse manifests written under another version.
#: v2: the health machine's arrays (``health.*``, present only when the
#: monitor tracks health) + ``strict_ids``/``health``/``health_every_s``
#: /``next_health_t``/``n_rejected`` meta.
SCHEMA_VERSION = 2

# -- field registries (name -> dtype kind), the reference's -----------------
DEVICE_STATE_FIELDS = {
    "last_t": "f8", "last_v": "f8", "has": "b1", "first_t": "f8",
    "n_samples": "i8", "n_dup": "i8", "n_late": "i8",
    "energy_j": "f8", "energy_corr_j": "f8",
    "win_j": "f8", "win_corr_j": "f8",
    "run_t": "f8", "n_changes": "i8", "ewma_w": "f8", "n_out": "i8",
}

#: ring tensors; ``t``/``v``/``e_raw``/``e_corr`` exist only when
#: ``slots > 0`` (optional in the registry walk)
RING_FIELDS = {"n_written": "i8"}
RING_SLOT_FIELDS = {"t": "f8", "v": "f8", "e_raw": "f8", "e_corr": "f8"}

PERIOD_FIELDS = {"edges": "f8", "counts": "i8", "sums": "f8"}

CORRECTION_FIELDS = {
    "gain": "f8", "offset_w": "f8", "time_shift_s": "f8",
    "baseline_w": "f8", "ref_period_s": "f8", "calibrated": "b1",
}

#: per-device configuration, set at construction or ``set_windows``
CONFIG_FIELDS = {
    "win_a": "f8", "win_b": "f8", "max_hold": "f8",
    "env_lo": "f8", "env_hi": "f8", "label_codes": "i8",
}

#: per-label Chan–Welford reading moments, stacked over the sorted label
#: names recorded in the manifest meta
MOMENT_FIELDS = {"n": "i8", "mean": "f8", "m2": "f8",
                 "mean_abs": "f8", "max_abs": "f8"}

#: the health machine's tensors; present only with a ``HealthPolicy``
HEALTH_FIELDS = {"code": "i1", "since_t": "f8", "clean_t": "f8",
                 "clean": "b1", "last_n_out": "i8", "n_quarantines": "i8"}

_KIND = {torch.float64: "f8", torch.int64: "i8", torch.int8: "i1",
         torch.bool: "b1"}


class SchemaError(RuntimeError):
    """A live object's fields diverged from the declared registry (or a
    checkpoint was written under another schema)."""


def dtype_kind(x) -> str:
    """The registry kind of a tensor's or an array's dtype (``f8``, ``i8``,
    ``i1``, ``b1``; any other type by its name, which no registry
    declares)."""
    if isinstance(x, torch.Tensor):
        return _KIND.get(x.dtype, str(x.dtype))
    return np.dtype(x.dtype).str[1:]


def _array_attrs(obj: Any) -> Dict[str, torch.Tensor]:
    """The tensor-valued attributes of a dataclass or plain object."""
    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    else:
        items = list(vars(obj).items())
    return {k: v for k, v in items if isinstance(v, torch.Tensor)}


def check_registry(obj: Any, registry: Dict[str, str], what: str,
                   optional: Optional[Dict[str, str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Validate ``obj``'s tensor attributes against ``registry`` and return
    them as ``{field: tensor}``.  Extra or missing tensors raise
    :class:`SchemaError` naming them; ``optional`` fields may be absent
    but must match their dtype when present."""
    arrays = _array_attrs(obj)
    allowed = dict(registry, **(optional or {}))
    missing = sorted(set(registry) - set(arrays))
    extra = sorted(set(arrays) - set(allowed))
    if missing or extra:
        raise SchemaError(
            f"{what} diverged from schema v{SCHEMA_VERSION}: "
            + (f"missing {missing} " if missing else "")
            + (f"undeclared {extra} " if extra else "")
            + "— update repro_torch.core.stream.schema (and bump "
              "SCHEMA_VERSION) alongside the state change")
    for name, arr in arrays.items():
        if dtype_kind(arr) != allowed[name]:
            raise SchemaError(f"{what}.{name}: dtype {arr.dtype} != "
                              f"declared {allowed[name]}")
    return arrays


def registry_nbytes(obj: Any, registry: Dict[str, str], what: str,
                    optional: Optional[Dict[str, str]] = None) -> int:
    """Resident bytes of ``obj``'s declared tensors: the walk behind the
    components' ``nbytes()``, validated as checkpointing validates it."""
    return sum(a.nbytes
               for a in check_registry(obj, registry, what, optional).values())


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy, finished when this returns (``copy=True``: a CPU
    tensor's ``.cpu()`` is the tensor itself)."""
    return x.detach().to("cpu", copy=True).numpy()


# -- monitor-level pack / unpack --------------------------------------------
def pack_monitor(mon) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Flatten a live :class:`~.monitor.MonitorService` (or its ingest
    core) into ``(arrays, meta)``: ``arrays`` a flat ``{"group.field":
    ndarray}`` dict of host copies, taken synchronously (ingestion may
    mutate the tensors as soon as this returns), ``meta`` the JSON-able
    configuration that rebuilds the monitor.  The keys, dtypes and meta
    are the reference's; ``meta["backend"]`` is ``"torch"``.
    :func:`unpack_monitor` inverts it bitwise."""
    core = getattr(mon, "_core", mon)
    arrays: Dict[str, np.ndarray] = {}
    for group, obj, registry, what, optional in (
            ("state", core.state, DEVICE_STATE_FIELDS, "DeviceState", None),
            ("ring", core.ring, RING_FIELDS, "IngestBuffer",
             RING_SLOT_FIELDS),
            ("periods", core.periods, PERIOD_FIELDS,
             "OnlinePeriodEstimator", None)):
        for k, v in check_registry(obj, registry, what, optional).items():
            arrays[f"{group}.{k}"] = _host(v)
    cfg = {"win_a": core._win_a, "win_b": core._win_b,
           "max_hold": core._max_hold, "env_lo": core._env_lo,
           "env_hi": core._env_hi, "label_codes": core._label_codes}
    for group, fields, get in (
            ("corrections", CORRECTION_FIELDS,
             lambda k: getattr(core.corrections, k)),
            ("config", CONFIG_FIELDS, cfg.__getitem__)):
        for k, want in fields.items():
            t = get(k)
            if dtype_kind(t) != want:
                raise SchemaError(f"{group}.{k}: dtype {t.dtype} != "
                                  f"declared {want}")
            arrays[f"{group}.{k}"] = _host(t)
    moment_labels = sorted(core._moments)
    for k, want in MOMENT_FIELDS.items():
        arrays[f"moments.{k}"] = np.array(
            [getattr(core._moments[lb], k) for lb in moment_labels],
            dtype=np.int64 if want == "i8" else np.float64).reshape(
                len(moment_labels))
    if core.health is not None:
        for k, v in check_registry(core.health, HEALTH_FIELDS,
                                   "HealthTracker").items():
            arrays[f"health.{k}"] = _host(v)
    meta = {
        "schema_version": SCHEMA_VERSION,
        "n_devices": int(core.n_devices),
        "backend": "torch",
        "trapezoid": bool(core.trapezoid),
        "ring_slots": int(core.ring.slots),
        "min_runs": int(core.periods.min_runs),
        "silent_after_s": (None if core.silent_after_s is None
                           else float(core.silent_after_s)),
        "drift_tau_s": float(core.drift_tau_s),
        "drift_rel": float(core.drift_rel),
        "drift_abs_w": float(core.drift_abs_w),
        "n_invalid": int(core._n_invalid),
        "n_rejected": int(core._n_rejected),
        "strict_ids": bool(core.strict_ids),
        "health": (None if core.health_policy is None
                   else core.health_policy.to_meta()),
        "health_every_s": float(core.health_every_s),
        # -inf (never evaluated) is not JSON-able; None stands in
        "next_health_t": (None if core._next_health_t == -np.inf
                          else float(core._next_health_t)),
        "epoch": int(core.epoch),
        "label_names": list(core._label_names),
        "moment_labels": moment_labels,
    }
    return arrays, meta


def expected_keys(meta: Dict[str, Any]) -> set:
    """The exact array-key set a checkpoint with ``meta`` must hold (the
    ring's slot arrays only when the ring was enabled, the health arrays
    only with a policy)."""
    keys = {f"state.{k}" for k in DEVICE_STATE_FIELDS}
    keys |= {f"ring.{k}" for k in RING_FIELDS}
    if int(meta.get("ring_slots", 0)) > 0:
        keys |= {f"ring.{k}" for k in RING_SLOT_FIELDS}
    keys |= {f"periods.{k}" for k in PERIOD_FIELDS}
    keys |= {f"corrections.{k}" for k in CORRECTION_FIELDS}
    keys |= {f"config.{k}" for k in CONFIG_FIELDS}
    keys |= {f"moments.{k}" for k in MOMENT_FIELDS}
    if meta.get("health") is not None:
        keys |= {f"health.{k}" for k in HEALTH_FIELDS}
    return keys


_REGISTRY = {"state": DEVICE_STATE_FIELDS,
             "ring": dict(RING_FIELDS, **RING_SLOT_FIELDS),
             "periods": PERIOD_FIELDS, "corrections": CORRECTION_FIELDS,
             "config": CONFIG_FIELDS, "moments": MOMENT_FIELDS,
             "health": HEALTH_FIELDS}


def unpack_monitor(arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
                   device="cuda"):
    """Rebuild a port :class:`~.monitor.MonitorService` on ``device`` from a
    :func:`pack_monitor` flattening (the port's or the reference's,
    whatever ``meta["backend"]`` says) — bitwise: continuing the stream
    from the rebuilt monitor is indistinguishable from never stopping."""
    from repro_torch._device import resolve_device
    from repro_torch.core.fleet_engine import StreamingMoments
    from repro_torch.core.stream.estimators import StreamCorrections
    from repro_torch.core.stream.health import HealthPolicy
    from repro_torch.core.stream.monitor import MonitorService

    version = meta.get("schema_version")
    if version != SCHEMA_VERSION:
        raise SchemaError(f"checkpoint written under monitor schema "
                          f"v{version}, this build reads v{SCHEMA_VERSION}"
                          f" — no migration path is registered")
    want = expected_keys(meta)
    got = set(arrays)
    if want - got or got - want:
        raise SchemaError(
            f"checkpoint array set diverged from schema "
            f"v{SCHEMA_VERSION}: missing {sorted(want - got)}, "
            f"undeclared {sorted(got - want)}")
    for key, a in arrays.items():
        group, field = key.split(".", 1)
        if dtype_kind(np.asarray(a)) != _REGISTRY[group][field]:
            raise SchemaError(f"checkpoint {key}: dtype {a.dtype} != "
                              f"declared {_REGISTRY[group][field]}")
    dev = resolve_device(device)

    def tensor(key: str) -> torch.Tensor:
        # torch.tensor copies: the rebuilt state shares no memory with
        # the caller's arrays
        return torch.tensor(np.asarray(arrays[key]), device=dev)

    n = int(meta["n_devices"])
    corr = StreamCorrections(**{k: tensor(f"corrections.{k}")
                                for k in CORRECTION_FIELDS})
    names = np.asarray(meta["label_names"], dtype=object)
    labels = names[np.asarray(arrays["config.label_codes"])]
    policy = (None if meta["health"] is None
              else HealthPolicy.from_meta(meta["health"]))
    mon = MonitorService(
        n, corrections=corr, labels=labels,
        integration="trapezoid" if meta["trapezoid"] else "rectangle",
        ring_slots=int(meta["ring_slots"]),
        min_runs=int(meta["min_runs"]),
        silent_after_s=meta["silent_after_s"],
        drift_tau_s=meta["drift_tau_s"], drift_rel=meta["drift_rel"],
        drift_abs_w=meta["drift_abs_w"],
        strict_ids=bool(meta["strict_ids"]), health=policy,
        health_every_s=float(meta["health_every_s"]), device=dev)
    core = mon.core
    for k in DEVICE_STATE_FIELDS:
        setattr(core.state, k, tensor(f"state.{k}"))
    core.ring.n_written = tensor("ring.n_written")
    if core.ring.slots:
        for k in RING_SLOT_FIELDS:
            setattr(core.ring, k, tensor(f"ring.{k}"))
    for k in PERIOD_FIELDS:
        setattr(core.periods, k, tensor(f"periods.{k}"))
    for k, attr in (("win_a", "_win_a"), ("win_b", "_win_b"),
                    ("max_hold", "_max_hold"), ("env_lo", "_env_lo"),
                    ("env_hi", "_env_hi")):
        setattr(core, attr, tensor(f"config.{k}"))
    core._moments = {}
    for i, lb in enumerate(meta["moment_labels"]):
        sm = StreamingMoments()
        sm.n = int(arrays["moments.n"][i])
        for k in ("mean", "m2", "mean_abs", "max_abs"):
            setattr(sm, k, float(arrays[f"moments.{k}"][i]))
        core._moments[lb] = sm
    if core.health is not None:
        for k in HEALTH_FIELDS:
            setattr(core.health, k, tensor(f"health.{k}"))
    core._n_invalid = int(meta["n_invalid"])
    core._n_rejected = int(meta["n_rejected"])
    core._next_health_t = (-np.inf if meta["next_health_t"] is None
                           else float(meta["next_health_t"]))
    core.epoch = int(meta["epoch"])
    return mon
