"""The port's monitor checkpoints: bitwise resume, typed errors, schema
drift, and the layout crossing both ways with the JAX package's.

A checkpoint the reference writes (numpy tier) restores in the port with
state arrays bitwise the reference's; one the port writes restores in the
reference with ``restore_monitor(root, backend="numpy")`` with arrays
bitwise the port's; the files themselves are the same bytes.  Port-to-
port resume is bitwise; port against reference answers are held to
rtol 1e-12 on energies and bitwise on counts, codes and flags.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_resilience import _fingerprint, _slabs, _steady  # noqa: E402
from test_torch_resilience import (_both_monitors,  # noqa: E402
                                   _health_pair, _np, assert_arrays_equal,
                                   assert_fingerprints_equal,
                                   assert_fingerprints_match)

from repro.core.stream import restore_monitor as r_restore  # noqa: E402
from repro.core.stream import save_monitor as r_save  # noqa: E402
from repro.core.stream import schema as rschema  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.stream import (CheckpointError,  # noqa: E402
                                     DeviceState, HealthPolicy,
                                     MissingCheckpointError, SchemaError,
                                     restore_monitor, save_monitor)
from repro_torch.core.stream import schema  # noqa: E402
from repro_torch.core.stream.checkpoint import checkpoint_steps  # noqa: E402

CPU = "cpu"


def _port(n, seed=0, **kw):
    return _both_monitors(n, seed=seed, **kw)[1]


def _saved(tmp_path, step=None, n=4):
    mon = _port(n)
    mon.ingest(*_slabs(n, n_slabs=4, seed=2)[0])
    root = str(tmp_path / "ck")
    save_monitor(mon, root, step=step)
    return mon, root


def _npys(root, step):
    d = os.path.join(root, f"step_{step}")
    return d, sorted(f for f in os.listdir(d) if f.endswith(".npy"))


# ---------------------------------------------------------------------------
# port -> port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("health", [False, True])
def test_restore_resumes_bitwise(tmp_path, health):
    n = 6
    kw = (dict(health=HealthPolicy(), health_every_s=0.3, silent_after_s=0.4)
          if health else {})
    slabs = _slabs(n, n_slabs=6, seed=13)
    ref = _port(n, seed=13, **kw)
    live = _port(n, seed=13, **kw)
    for k, s in enumerate(slabs):
        ref.ingest(*s)
        if k < 3:
            live.ingest(*s)
    save_monitor(live, str(tmp_path / "ck"))
    resumed = restore_monitor(str(tmp_path / "ck"), device=CPU)
    assert resumed.epoch == live.epoch
    assert resumed.counters == live.counters
    for s in slabs[3:]:
        resumed.ingest(*s)
    assert_fingerprints_equal(_fingerprint(resumed), _fingerprint(ref))
    assert_arrays_equal(convert.monitor_arrays(resumed),
                        convert.monitor_arrays(ref))
    assert resumed.reading_stats() == ref.reading_stats()


def test_pack_unpack_roundtrip_preserves_everything():
    mon = _port(7, seed=21, health=HealthPolicy(), silent_after_s=0.3)
    for s in _slabs(7, 4, seed=21):
        mon.ingest(*s)
    mon.ingest(np.array([0, 1]), np.array([np.nan, 99.0]),
               np.array([1.0, np.inf]))
    mon.update_health(2.5)
    arrays, meta = schema.pack_monitor(mon)
    assert meta["backend"] == "torch"
    clone = schema.unpack_monitor(arrays, meta, device=CPU)
    assert clone.epoch == mon.epoch
    assert clone.counters == mon.counters
    assert list(clone.labels) == list(mon.labels)
    assert clone.health_policy == mon.health_policy
    assert_fingerprints_equal(_fingerprint(clone), _fingerprint(mon))
    again, meta2 = schema.pack_monitor(clone)
    assert meta2 == meta
    assert_arrays_equal(again, arrays)
    for k, a in again.items():
        assert a.dtype == arrays[k].dtype, k


def test_pack_copies_off_the_state():
    """What ``pack_monitor`` returns does not move when ingestion goes on
    (an asynchronous write reads it afterwards)."""
    mon = _port(4)
    mon.ingest(*_slabs(4, 1, seed=1)[0])
    arrays, _ = schema.pack_monitor(mon)
    frozen = {k: v.copy() for k, v in arrays.items()}
    mon.ingest(*_slabs(4, 2, seed=1)[1])
    assert_arrays_equal(arrays, frozen)


def test_health_monitor_checkpoint_roundtrip(tmp_path):
    _, mon = _health_pair()
    _steady(mon, [0, 1, 2], 0.0, 1.0)
    _steady(mon, [0], 1.0, 1.3)
    mon.update_health(1.6)
    root = str(tmp_path / "ck")
    save_monitor(mon, root)
    clone = restore_monitor(root, device=CPU)
    assert clone.health_policy == mon.health_policy
    assert torch.equal(clone.health.code, mon.health.code)
    assert clone.health.code.dtype == torch.int8
    assert clone.health.clean.dtype == torch.bool
    assert_fingerprints_equal(_fingerprint(clone), _fingerprint(mon))
    clone.update_health(2.6)
    mon.update_health(2.6)
    assert torch.equal(clone.health.code, mon.health.code)


# ---------------------------------------------------------------------------
# typed errors and fallback (tests/test_resilience.py's cases)
# ---------------------------------------------------------------------------
def test_missing_root_and_step_raise_missing_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_monitor(str(tmp_path / "nope"), device=CPU)
    with pytest.raises(MissingCheckpointError):
        restore_monitor(str(tmp_path / "nope"), device=CPU)
    _, root = _saved(tmp_path, step=3)
    with pytest.raises(MissingCheckpointError, match="step_9"):
        restore_monitor(root, step=9, device=CPU)


def test_truncated_array_raises_checkpoint_error(tmp_path):
    _, root = _saved(tmp_path, step=1)
    d, npys = _npys(root, 1)
    victim = os.path.join(d, npys[0])
    with open(victim, "rb") as f:
        head = f.read(16)
    with open(victim, "wb") as f:
        f.write(head)
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        restore_monitor(root, device=CPU)


def test_missing_array_and_manifest_raise_checkpoint_error(tmp_path):
    _, root = _saved(tmp_path, step=1)
    d, npys = _npys(root, 1)
    os.remove(os.path.join(d, npys[0]))
    with pytest.raises(CheckpointError, match="missing"):
        restore_monitor(root, device=CPU)
    os.remove(os.path.join(d, "manifest.json"))
    with pytest.raises(CheckpointError, match="manifest.json missing"):
        restore_monitor(root, device=CPU)


def test_garbled_manifest_raises_checkpoint_error(tmp_path):
    _, root = _saved(tmp_path, step=1)
    with open(os.path.join(root, "step_1", "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointError, match="unreadable manifest"):
        restore_monitor(root, device=CPU)
    with open(os.path.join(root, "step_1", "manifest.json"), "w") as f:
        json.dump({"step": 1}, f)
    with pytest.raises(CheckpointError, match="not a monitor checkpoint"):
        restore_monitor(root, device=CPU)


def test_fallback_restores_newest_complete_generation(tmp_path):
    mon = _port(4)
    slabs = _slabs(4, n_slabs=3, seed=2)
    root = str(tmp_path / "ck")
    mon.ingest(*slabs[0])
    save_monitor(mon, root, step=1)
    want = _fingerprint(mon)
    mon.ingest(*slabs[1])
    save_monitor(mon, root, step=2)
    d, npys = _npys(root, 2)
    os.remove(os.path.join(d, npys[0]))
    with pytest.raises(CheckpointError):
        restore_monitor(root, device=CPU)
    clone = restore_monitor(root, fallback=True, device=CPU)
    assert_fingerprints_equal(_fingerprint(clone), want)
    os.remove(os.path.join(root, "step_1", "manifest.json"))
    with pytest.raises(CheckpointError, match="no readable checkpoint"):
        restore_monitor(root, fallback=True, device=CPU)


def test_save_extras_roundtrip_and_collision(tmp_path):
    mon = _port(3)
    mon.ingest(*_slabs(3, n_slabs=1, seed=0)[0])
    root = str(tmp_path / "ck")
    save_monitor(mon, root, step=5, extras={"slab_seq": 41})
    clone, meta = restore_monitor(root, with_meta=True, device=CPU)
    assert meta["slab_seq"] == 41
    assert clone.epoch == mon.epoch
    with pytest.raises(ValueError, match="collide"):
        save_monitor(mon, root, step=6, extras={"epoch": 0})


def test_async_save_and_retention(tmp_path):
    """Back-to-back asynchronous saves to one root queue on one writer
    and garbage-collect in order."""
    mon = _port(4)
    root = str(tmp_path / "ckpt")
    steps, mgrs = [], set()
    for dev, t, v in _slabs(4, 5, seed=11):
        mon.ingest(dev, t, v)
        mgrs.add(id(save_monitor(mon, root, asynchronous=True, retain=2)))
        steps.append(mon.epoch)
    assert len(mgrs) == 1
    save_monitor(mon, root, asynchronous=True, retain=2).wait()
    assert checkpoint_steps(root) == steps[-2:]
    restored = restore_monitor(root, device=CPU)
    assert torch.equal(restored.state.energy_corr_j,
                       mon.state.energy_corr_j)
    with pytest.raises(FileNotFoundError):
        restore_monitor(root, step=steps[0], device=CPU)


# ---------------------------------------------------------------------------
# schema drift fails loudly
# ---------------------------------------------------------------------------
def test_new_state_field_fails_loudly(tmp_path):
    @dataclasses.dataclass
    class GrownState(DeviceState):
        shiny_new: torch.Tensor = None

    mon = _port(3)
    mon.core.state = GrownState(
        **{f.name: getattr(mon.state, f.name)
           for f in dataclasses.fields(DeviceState)},
        shiny_new=torch.zeros(3))
    with pytest.raises(SchemaError, match="shiny_new"):
        mon.nbytes()
    with pytest.raises(SchemaError, match="shiny_new"):
        save_monitor(mon, str(tmp_path / "ckpt"))
    with pytest.raises(SchemaError, match="shiny_new"):
        mon.grow(4)
    assert mon.n_devices == 3 and mon.corrections.n_devices == 3


def test_dtype_drift_fails_loudly():
    mon = _port(3, health=HealthPolicy())
    mon.core.state.n_samples = mon.state.n_samples.to(torch.float32)
    with pytest.raises(SchemaError, match="n_samples"):
        mon.nbytes()
    mon = _port(3, health=HealthPolicy())
    mon.health.code = mon.health.code.to(torch.int64)
    with pytest.raises(SchemaError, match="code"):
        mon.nbytes()


def test_restore_rejects_version_keyset_and_dtype_mismatch():
    mon = _port(3)
    mon.ingest(*_slabs(3, 1, seed=1)[0])
    arrays, meta = schema.pack_monitor(mon)
    with pytest.raises(SchemaError, match="schema"):
        schema.unpack_monitor(arrays, {**meta, "schema_version": 99},
                              device=CPU)
    missing = dict(arrays)
    missing.pop("state.energy_corr_j")
    with pytest.raises(SchemaError, match="energy_corr_j"):
        schema.unpack_monitor(missing, meta, device=CPU)
    extra = dict(arrays, **{"state.bogus": np.zeros(3)})
    with pytest.raises(SchemaError, match="bogus"):
        schema.unpack_monitor(extra, meta, device=CPU)
    drifted = dict(arrays)
    drifted["state.has"] = arrays["state.has"].astype(np.int64)
    with pytest.raises(SchemaError, match="state.has"):
        schema.unpack_monitor(drifted, meta, device=CPU)


def test_registries_are_the_references():
    for name in ("SCHEMA_VERSION", "DEVICE_STATE_FIELDS", "RING_FIELDS",
                 "RING_SLOT_FIELDS", "PERIOD_FIELDS", "CORRECTION_FIELDS",
                 "CONFIG_FIELDS", "MOMENT_FIELDS", "HEALTH_FIELDS"):
        assert getattr(schema, name) == getattr(rschema, name), name


def test_nbytes_is_the_schema_walk():
    mon = _port(5, health=HealthPolicy())
    arrays, _ = schema.pack_monitor(mon)
    per_device = sum(a.nbytes for k, a in arrays.items()
                     if k.split(".")[0] in ("state", "ring", "health")
                     or k in ("periods.counts", "periods.sums"))
    assert mon.nbytes() == per_device + mon.core.periods.edges.nbytes
    rmon = _both_monitors(5, health=HealthPolicy())[0]
    assert mon.nbytes() == rmon.nbytes()


# ---------------------------------------------------------------------------
# the layout crosses both ways
# ---------------------------------------------------------------------------
def _cross_pair(health):
    kw = (dict(health=HealthPolicy(recover_after_s=0.2), health_every_s=0.3,
               silent_after_s=0.4, strict_ids=False) if health else {})
    ref, port = _both_monitors(6, seed=9, **kw)
    slabs = _slabs(6, n_slabs=6, seed=9)
    for s in slabs[:3]:
        ref.ingest(*s)
        port.ingest(*s)
    return ref, port, slabs[3:]


@pytest.mark.parametrize("health", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, health):
    ref, _, rest = _cross_pair(health)
    root = str(tmp_path / "ck")
    r_save(ref, root)
    port = restore_monitor(root, device=CPU)
    want, _ = rschema.pack_monitor(ref)
    got, meta = schema.pack_monitor(port)
    assert meta["backend"] == "torch"
    assert_arrays_equal(got, want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
    assert port.counters == ref.counters
    for s in rest:
        ref.ingest(*s)
        port.ingest(*s)
    assert_fingerprints_match(_fingerprint(ref), _fingerprint(port))


@pytest.mark.parametrize("health", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, health):
    _, port, rest = _cross_pair(health)
    root = str(tmp_path / "ck")
    save_monitor(port, root)
    ref = r_restore(root, backend="numpy")
    want, meta = schema.pack_monitor(port)
    got, rmeta = rschema.pack_monitor(ref)
    assert_arrays_equal(got, want)
    assert {k: v for k, v in rmeta.items() if k != "backend"} == \
        {k: v for k, v in meta.items() if k != "backend"}
    for s in rest:
        ref.ingest(*s)
        port.ingest(*s)
    assert_fingerprints_match(_fingerprint(ref), _fingerprint(port))


def test_the_files_are_the_references_byte_for_byte(tmp_path):
    """The reference writes a checkpoint, the port restores and writes it
    again: every ``.npy`` is the same bytes and the manifests differ only
    in the meta's ``backend``."""
    ref, _, _ = _cross_pair(True)
    r_root, t_root = str(tmp_path / "ref"), str(tmp_path / "port")
    r_save(ref, r_root, step=7)
    save_monitor(restore_monitor(r_root, device=CPU), t_root, step=7)
    (rd, r_files), (td, t_files) = _npys(r_root, 7), _npys(t_root, 7)
    assert r_files == t_files
    for f in r_files:
        with open(os.path.join(rd, f), "rb") as a, \
                open(os.path.join(td, f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(rd, "manifest.json")) as a, \
            open(os.path.join(td, "manifest.json")) as b:
        mr, mt = json.load(a), json.load(b)
    assert (mr["extras"].pop("backend"), mt["extras"].pop("backend")) == \
        ("numpy", "torch")
    assert mr == mt
    assert list(mr["trees"]["monitor"]) == list(mt["trees"]["monitor"])


def test_convert_carries_the_health_arrays():
    ref, port = _health_pair()
    for mon in (ref, port):
        _steady(mon, [0, 1, 2], 0.0, 1.0)
        _steady(mon, [0], 1.0, 1.3)
    ref.update_health(1.6)
    arrays, meta = rschema.pack_monitor(ref)
    convert.load_monitor_state(port, arrays, meta["moment_labels"])
    out = convert.monitor_arrays(port)
    for k in schema.HEALTH_FIELDS:
        np.testing.assert_array_equal(out[f"health.{k}"],
                                      arrays[f"health.{k}"], err_msg=k)
        assert out[f"health.{k}"].dtype == arrays[f"health.{k}"].dtype
    assert _np(port.health.code).tolist() == [0, 1, 1]
    assert set(out) == set(arrays) - {
        f"{g}.{k}" for g, fields in (("corrections",
                                      schema.CORRECTION_FIELDS),
                                     ("config", schema.CONFIG_FIELDS))
        for k in fields}


def test_restore_runs_on_the_card_unless_asked(tmp_path):
    """``restore_monitor`` builds on the card by default and refuses a
    missing card rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    _, root = _saved(tmp_path, step=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        restore_monitor(root)
    assert restore_monitor(root, device=CPU).device == torch.device("cpu")
