"""The port's collector (``repro_torch.collect``) and versioned
calibration store (``repro_torch.core.calibrate_store``) against the JAX
package's (``repro.collect``, ``repro.core.calibrate_store``).

Tolerances, per group:

* wire: cell values, parsed batches and parse accounting of both
  committed fixtures (``tests/data/``) bitwise the reference's; the
  writers' text equal to the reference's;
* registry: ids, ``first_seen_t`` and summaries equal under every
  policy;
* store: the files under ``devices/<id>/`` and ``active.json`` byte for
  byte the reference's, each package reading the other's store;
  ``resolve_corrections`` bitwise (labels and active counts equal);
* monitor paths (``device="cpu"`` against the port's own direct
  construction or ``replay``): bitwise;
* the CLI (``--torch-device cpu``) against the reference CLI's
  ``--backend numpy``: wire, registry and pipeline counters equal,
  joules and sigmas within 1e-12 relative.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_draws  # noqa: E402
from test_torch_audit import _tl  # noqa: E402

from repro.collect import (CollectorPipeline as RPipeline,  # noqa: E402
                           DeviceRegistry as RRegistry,
                           SimulatedSampler as RSampler, wire as rwire)
from repro.collect.cli import main as r_cli_main  # noqa: E402
from repro.core import calibrate_store as rstore  # noqa: E402
from repro.core import fleet_engine as rfe  # noqa: E402
from repro.core import load as rload  # noqa: E402
from repro.core.calibrate import CalibrationRecord as RRecord  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.collect import (CollectorPipeline,  # noqa: E402
                                 DeviceRegistry, NvmlSampler, SampleBatch,
                                 SimulatedSampler, SlabAssembler,
                                 UnknownDeviceError, wire)
from repro_torch.collect.cli import main as cli_main  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.core.calibrate import (CalibrationRecord,  # noqa: E402
                                        nominal_record)
from repro_torch.core.calibrate_store import (ArtifactStore,  # noqa: E402
                                              StoreError, record_stamp,
                                              resolve_corrections)
from repro_torch.core.stream import MonitorService, replay  # noqa: E402

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
DAEMON_FIXTURE = os.path.join(DATA, "daemon_sample.csv")
SMI_FIXTURE = os.path.join(DATA, "smi_sample.csv")
FIXTURES = [("daemon_sample.csv", DAEMON_FIXTURE),
            ("smi_sample.csv", SMI_FIXTURE)]
# the reference tests' pins of the fixtures' accounting
FIXTURE_EXPECT = {
    "daemon_sample.csv": {"rows": 1306, "samples": 1302, "headers": 2,
                          "blank": 1, "malformed": 2, "not_available": 0,
                          "error_cells": 0},
    "smi_sample.csv": {"rows": 962, "samples": 957, "headers": 2,
                       "blank": 0, "malformed": 0, "not_available": 1,
                       "error_cells": 2},
}
FIXTURE_UUIDS = [f"GPU-f1xt-{i:04d}" for i in range(5)]
J_RTOL = 1e-12


def _assert_batch_equal(got, want):
    np.testing.assert_array_equal(got.uuid, want.uuid)
    for f in ("t", "power_w", "util"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.float64, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_monitor_equal(a, b):
    for f in ("energy_j", "energy_corr_j", "win_corr_j", "n_samples",
              "last_t", "n_dup", "n_late"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert torch.equal(a.ring.t, b.ring.t)
    assert torch.equal(a.ring.e_corr, b.ring.e_corr)
    fa, fb = a.fleet_energy(), b.fleet_energy()
    assert torch.equal(fa.per_device_j, fb.per_device_j)
    assert fa.total_j == fb.total_j
    assert a.counters == b.counters


# ---------------------------------------------------------------------------
# wire: cell parsers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell,watts,status", [
    ("68.84 W", 68.84, "ok"),
    ("68840 mW", 68.84, "ok"),
    ("0.25 kW", 250.0, "ok"),
    ("132.5", 132.5, "ok"),               # csv,nounits
    ("  99.0 w ", 99.0, "ok"),
    ("[N/A]", None, "na"),
    ("N/A", None, "na"),
    ("[Unknown Error]", None, "error"),
    ("ERR!", None, "error"),
    ("[Unsupported]", None, "error"),
    ("12 parsecs", None, "malformed"),
    ("watts 12", None, "malformed"),
    ("", None, "malformed"),
])
def test_power_cell(cell, watts, status):
    w, s = wire.parse_power_cell(cell)
    rw, rs = rwire.parse_power_cell(cell)
    assert s == status == rs
    if watts is None:
        assert np.isnan(w) and np.isnan(rw)
    else:
        assert w == rw
        assert w == pytest.approx(watts, rel=1e-12)


def test_timestamp_cell_formats():
    cells = ["1700000000.25", "2023/11/14 22:13:20.500",
             "2023/11/14 22:13:20", "2023-11-14T22:13:20",
             "2023-11-14 22:13:20.250", "yesterday", "2023/11/14 xx.5"]
    for cell in cells:
        got, want = (wire.parse_timestamp_cell(cell),
                     rwire.parse_timestamp_cell(cell))
        assert got == want or (np.isnan(got) and np.isnan(want)), cell
    # nvidia-smi's format, with and without milliseconds, taken as UTC
    assert wire.parse_timestamp_cell("2023/11/14 22:13:20.500") \
        == 1700000000.5
    assert wire.parse_timestamp_cell("2023/11/14 22:13:20") == 1700000000.0
    assert np.isnan(wire.parse_timestamp_cell("yesterday"))


def test_util_cell():
    assert wire.parse_util_cell(" 85 % ") == 85.0
    assert wire.parse_util_cell("85") == 85.0
    assert np.isnan(wire.parse_util_cell("[N/A]"))
    assert np.isnan(wire.parse_util_cell(""))


# ---------------------------------------------------------------------------
# wire: round trips, writers, fixtures
# ---------------------------------------------------------------------------

def _random_batch(n=257, seed=0):
    rng = np.random.default_rng(seed)
    uuids = np.asarray([f"GPU-{rng.integers(0, 8):x}" for _ in range(n)],
                       dtype=object)
    t = 1.7e9 + np.sort(rng.uniform(0.0, 60.0, n))
    p = rng.uniform(30.0, 700.0, n)
    u = rng.uniform(0.0, 100.0, n)
    u[rng.random(n) < 0.1] = np.nan
    return SampleBatch(uuid=uuids, t=t, power_w=p, util=u)


def test_daemon_round_trip_is_lossless():
    batch = _random_batch()
    text = wire.format_daemon(batch, precision=None)
    back, c = wire.parse_daemon(text)
    assert c.samples == len(batch) and c.malformed == 0
    _assert_batch_equal(back, batch)


@pytest.mark.parametrize("nounits", [False, True])
def test_smi_round_trip_within_quantisation(nounits):
    batch = _random_batch(seed=3)
    text = wire.format_query_gpu(batch, nounits=nounits)
    back, c = wire.parse_query_gpu(text)
    assert c.samples == len(batch) and c.headers == 1
    np.testing.assert_array_equal(back.uuid, batch.uuid)
    np.testing.assert_allclose(back.t, batch.t, atol=1.0e-3)
    np.testing.assert_allclose(back.power_w, batch.power_w, atol=0.005)


@pytest.mark.parametrize("fmt", ["daemon", "daemon_rounded", "smi",
                                 "smi_nounits"])
def test_writers_and_parsers_are_the_references(fmt):
    batch = _random_batch(seed=5)
    rbatch = rwire.SampleBatch(uuid=batch.uuid, t=batch.t,
                               power_w=batch.power_w, util=batch.util)
    if fmt.startswith("daemon"):
        prec = 2 if fmt == "daemon_rounded" else None
        text = wire.format_daemon(batch, precision=prec)
        assert text == rwire.format_daemon(rbatch, precision=prec)
        got, want = wire.parse_daemon(text), rwire.parse_daemon(text)
    else:
        nounits = fmt == "smi_nounits"
        text = wire.format_query_gpu(batch, nounits=nounits)
        assert text == rwire.format_query_gpu(rbatch, nounits=nounits)
        got, want = wire.parse_query_gpu(text), rwire.parse_query_gpu(text)
    _assert_batch_equal(got[0], want[0])
    assert got[1].as_dict() == want[1].as_dict()


@pytest.mark.parametrize("name,path", FIXTURES)
def test_fixture_parse_accounting_pinned(name, path):
    batch, c = wire.parse_log(path)
    rbatch, rc = rwire.parse_log(path)
    assert c.as_dict() == FIXTURE_EXPECT[name] == rc.as_dict()
    assert len(batch) == FIXTURE_EXPECT[name]["samples"]
    _assert_batch_equal(batch, rbatch)
    assert c.rows == (c.samples + c.headers + c.malformed
                      + c.not_available + c.error_cells)


def test_fixture_sniffing():
    with open(DAEMON_FIXTURE) as f:
        assert wire.sniff_format([next(f) for _ in range(3)]) == "daemon"
    with open(SMI_FIXTURE) as f:
        assert wire.sniff_format([next(f) for _ in range(3)]) == "smi"


@pytest.mark.parametrize("batch_rows", [7, 100, 10_000])
def test_iter_batches_chunking_invariant(batch_rows):
    whole, cw = wire.parse_log(DAEMON_FIXTURE)
    c = wire.WireCounters()
    parts = list(wire.iter_batches(DAEMON_FIXTURE, batch_rows=batch_rows,
                                   counters=c))
    got = parts[0]
    for b in parts[1:]:
        got = got.concat(b)
    _assert_batch_equal(got, whole)
    assert c.as_dict() == cw.as_dict()


def test_smi_fixture_chunking_carries_headers():
    whole, cw = wire.parse_log(SMI_FIXTURE)
    c = wire.WireCounters()
    parts = list(wire.iter_batches(SMI_FIXTURE, batch_rows=13, counters=c))
    got = parts[0]
    for b in parts[1:]:
        got = got.concat(b)
    _assert_batch_equal(got, whole)
    assert c.as_dict() == cw.as_dict()
    with pytest.raises(ValueError):
        list(wire.iter_batches(SMI_FIXTURE, batch_rows=0))


# ---------------------------------------------------------------------------
# device registry
# ---------------------------------------------------------------------------

def test_registry_first_seen_order_and_stamping():
    reg = DeviceRegistry()
    ids = reg.resolve(np.asarray(["b", "a", "b", "c"], dtype=object),
                      t=np.asarray([5.0, 6.0, 7.0, 8.0]))
    np.testing.assert_array_equal(ids, [0, 1, 0, 2])
    assert reg.uuids == ["b", "a", "c"]
    assert reg.first_seen_t == [5.0, 6.0, 8.0]
    assert reg.add("a") == 1 and reg.n_devices == 3
    assert "c" in reg and reg.id_of("c") == 2


def test_registry_reject_policy_counts():
    reg = DeviceRegistry(["a", "b"], on_unknown="reject")
    ids = reg.resolve(np.asarray(["a", "x", "b", "y"], dtype=object))
    np.testing.assert_array_equal(ids, [0, -1, 1, -1])
    assert reg.n_rejected == 2 and reg.n_devices == 2


def test_registry_raise_policy():
    reg = DeviceRegistry(["a"], on_unknown="raise")
    with pytest.raises(UnknownDeviceError):
        reg.resolve(np.asarray(["a", "nope"], dtype=object))
    with pytest.raises(ValueError):
        DeviceRegistry(on_unknown="explode")


@pytest.mark.parametrize("policy", ["add", "reject"])
def test_registry_matches_reference(policy):
    rng = np.random.default_rng(9)
    known = [f"GPU-{i}" for i in range(3)]
    port = DeviceRegistry(known, on_unknown=policy)
    ref = RRegistry(known, on_unknown=policy)
    for _ in range(5):
        k = int(rng.integers(0, 40))
        u = np.asarray([f"GPU-{i}" for i in rng.integers(0, 9, k)],
                       dtype=object)
        t = rng.uniform(0.0, 10.0, k)
        np.testing.assert_array_equal(port.resolve(u, t), ref.resolve(u, t))
    assert port.summary() == ref.summary()


# ---------------------------------------------------------------------------
# the pipeline and the sampler
# ---------------------------------------------------------------------------

def _stream_rows(n_all=4, late_at=100, polls=300, seed=2):
    """A sample stream where devices from n_all - 2 on join late."""
    rng = np.random.default_rng(seed)
    uuids = [f"GPU-{i}" for i in range(n_all)]
    rows = []
    for k in range(polls):
        fleet = uuids[:2] if k < late_at else uuids
        for u in fleet:
            rows.append((u, 0.01 * k, 50.0 + rng.standard_normal()))
    return uuids, SampleBatch.from_rows([r[0] for r in rows],
                                        [r[1] for r in rows],
                                        [r[2] for r in rows])


def _chunks(batch, size):
    for i in range(0, len(batch), size):
        yield SampleBatch(uuid=batch.uuid[i:i + size],
                          t=batch.t[i:i + size],
                          power_w=batch.power_w[i:i + size],
                          util=batch.util[i:i + size])


def test_pipeline_hot_add_bitwise_equals_upfront_construction():
    """Devices hot-added mid-stream (lenient registry, the port's
    ``grow``) give the bits of the full fleet known from the start."""
    uuids, batch = _stream_rows()
    pipe = CollectorPipeline(slab_samples=128, now=0.0, device=CPU)
    for chunk in _chunks(batch, 37):
        pipe.feed(chunk)
    grown = pipe.finish()
    assert grown.n_devices == 4 and grown.device.type == "cpu"

    asm = SlabAssembler(DeviceRegistry(uuids), slab_samples=128)
    upfront = MonitorService(4, strict_ids=False, device=CPU)
    for chunk in _chunks(batch, 37):
        for dev, t, v in asm.push(chunk):
            upfront.ingest(dev, t, v)
    for dev, t, v in asm.flush():
        upfront.ingest(dev, t, v)
    _assert_monitor_equal(grown, upfront)
    summary = pipe.summary()
    rpipe = RPipeline(slab_samples=128, now=0.0, backend="numpy")
    for chunk in _chunks(batch, 37):
        rpipe.feed(rwire.SampleBatch(chunk.uuid, chunk.t, chunk.power_w,
                                     chunk.util))
    rpipe.finish()
    assert summary == rpipe.summary()


def test_slab_boundaries_independent_of_feed_chunking():
    _, batch = _stream_rows(late_at=10_000)
    monitors = []
    for feed in (11, 97, 1200):
        pipe = CollectorPipeline(slab_samples=256, now=0.0, device=CPU)
        for chunk in _chunks(batch, feed):
            pipe.feed(chunk)
        monitors.append(pipe.finish())
        assert pipe.assembler.n_slabs == len(batch) // 256 + \
            (1 if len(batch) % 256 else 0)
    _assert_monitor_equal(monitors[0], monitors[1])
    _assert_monitor_equal(monitors[0], monitors[2])
    with pytest.raises(ValueError):
        SlabAssembler(DeviceRegistry(), slab_samples=0)


def test_pipeline_with_no_sample_has_no_monitor():
    pipe = CollectorPipeline(device=CPU)
    pipe.feed(SampleBatch.empty())
    assert pipe.finish() is None
    assert "ingest" not in pipe.summary()


def _bank(n=6, seed=3):
    bank = convert.sensor_bank(["a100"] * n, *(np.ones(n), np.zeros(n),
                                               np.linspace(0.0, 0.09, n)),
                               seed=seed, device=CPU)
    tl = rload.multi_phase_workload([(0.130, 215.0), (0.070, 165.0)])
    bank.attach(_tl(tl), t_end=2.0)
    return bank


def test_sampler_pipeline_matches_replay_bitwise():
    """SimulatedSampler → registry → assembler → monitor equals the
    port's flat ``replay`` bitwise when a slab is one replay tick."""
    n = 6
    bank = _bank(n)
    ref = MonitorService(n, device=CPU)
    replay(bank, ref, 0.0, 1.0, period_s=0.001, grid=False)

    sampler = SimulatedSampler(bank, t0=0.0, period_s=0.001)
    pipe = CollectorPipeline(slab_samples=500 * n, now=0.0, device=CPU)
    for batch in sampler.run(1000):
        pipe.feed(batch)
    mon = pipe.finish()
    assert mon.n_devices == n
    _assert_monitor_equal(mon, ref)


def test_sampler_batches_match_reference(monkeypatch):
    """The port's sampler over a bank carried from the reference's (hidden
    parameters and reading noise) polls what the reference's polls."""
    _torch_draws.substitute(monkeypatch, _torch_draws.reference_bank)
    names = ["a100", "v100", "h100_instant", "a100"]
    rb = rfe.SensorBank.from_catalog(names, seeds=np.arange(4) + 5)
    pb = convert.sensor_bank(names, rb.true_gain, rb.true_offset,
                             rb.true_phase, model_gain=rb._model_gain,
                             seed=5, device=CPU)
    tl = rload.multi_phase_workload([(0.130, 215.0), (0.070, 165.0)])
    rb.attach(tl, t_end=2.0)
    pb.attach(_tl(tl), t_end=2.0)
    rs, ps = RSampler(rb, period_s=0.003), SimulatedSampler(pb,
                                                             period_s=0.003)
    np.testing.assert_array_equal(ps.uuids, rs.uuids)
    for got, want in zip(ps.run(200), rs.run(200)):
        np.testing.assert_array_equal(got.uuid, want.uuid)
        np.testing.assert_array_equal(got.t, want.t)
        np.testing.assert_array_equal(got.power_w, want.power_w)
    assert ps.t_next == rs.t_next


def test_sampler_uuid_stability():
    bank = _bank(3)
    a, b = SimulatedSampler(bank), SimulatedSampler(bank)
    np.testing.assert_array_equal(a.uuids, b.uuids)
    assert len(set(a.uuids)) == 3
    with pytest.raises(ValueError):
        SimulatedSampler(bank, uuids=["x", "x", "y"])
    with pytest.raises(ValueError):
        SimulatedSampler(bank, period_s=0.0)


def test_nvml_sampler_needs_pynvml(monkeypatch):
    monkeypatch.setitem(sys.modules, "pynvml", None)
    with pytest.raises(RuntimeError, match="pynvml"):
        NvmlSampler()


# ---------------------------------------------------------------------------
# calibration artifacts
# ---------------------------------------------------------------------------

def _rec(device_id="GPU-a", gain=1.05, fitted_at=None, **kw):
    base = nominal_record(device_id, profiles.get("a100"))
    return dataclasses.replace(base, gain=gain, offset_w=-2.0,
                               fitted_at=fitted_at, **kw)


def _rrec(rec):
    return RRecord(**dataclasses.asdict(rec))


def test_store_versions_are_append_only(tmp_path):
    store = ArtifactStore(str(tmp_path))
    assert store.save(_rec(gain=1.01)) == 1
    assert store.save(_rec(gain=1.02), activate=True) == 2
    assert store.save(_rec(gain=1.03)) == 3
    assert store.active_version("GPU-a") == 2
    assert store.active("GPU-a").gain == 1.02
    infos = store.versions("GPU-a")
    assert [i.version for i in infos] == [1, 2, 3]
    assert [i.active for i in infos] == [False, True, False]
    assert infos[1].summary()["gain"] == 1.02
    store.activate("GPU-a", 1)
    assert store.active("GPU-a").gain == 1.01


def test_store_activate_phantom_raises(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.save(_rec())
    with pytest.raises(StoreError):
        store.activate("GPU-a", 99)
    with pytest.raises(StoreError):
        store.load("GPU-a", 99)
    with open(os.path.join(str(tmp_path), "active.json"), "w") as f:
        f.write("[1, 2]")
    with pytest.raises(StoreError, match="corrupt"):
        store.active_version("GPU-a")


def test_store_deactivate(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.save(_rec(), activate=True)
    assert store.deactivate("GPU-a") is True
    assert store.active("GPU-a") is None
    assert store.deactivate("GPU-a") is False


def test_store_age_out(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.save(_rec(fitted_at=1000.0), activate=True)
    assert store.active("GPU-a", max_age_s=500.0, now=1400.0) is not None
    assert store.active("GPU-a", max_age_s=500.0, now=1600.0) is None
    store.save(_rec(device_id="GPU-b", fitted_at=None), activate=True)
    assert record_stamp(store.active("GPU-b")) == 0.0
    assert store.active("GPU-b", max_age_s=1.0, now=1e12) is not None


def test_store_gc(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.save(_rec(fitted_at=100.0))                  # v1 stale
    store.save(_rec(fitted_at=200.0), activate=True)   # v2 stale, active
    store.save(_rec(fitted_at=900.0))                  # v3 fresh
    dry = store.gc(max_age_s=300.0, now=1000.0, dry_run=True)
    assert len(dry) == 1 and "v0001" in dry[0]
    assert len(store.versions("GPU-a")) == 3
    removed = store.gc(max_age_s=300.0, now=1000.0)
    assert [os.path.basename(p) for p in removed] == ["v0001.json"]
    assert [i.version for i in store.versions("GPU-a")] == [2, 3]
    removed = store.gc(max_age_s=300.0, now=1000.0, keep_active=False)
    assert [os.path.basename(p) for p in removed] == ["v0002.json"]


def test_store_schema_drift_both_directions(tmp_path):
    """Artifacts missing the provenance fields (an older writer) and
    with unknown extra fields (a newer one) both load."""
    store = ArtifactStore(str(tmp_path))
    store.save(_rec(), activate=True)
    path = store.versions("GPU-a")[0].path
    data = json.loads(open(path).read())
    for f in ("fitted_at", "source", "note"):
        data.pop(f)
    data["flux_capacitance"] = 1.21
    with open(path, "w") as f:
        json.dump(data, f)
    rec = store.active("GPU-a")
    assert rec.fitted_at is None and rec.source == "" and rec.note == ""
    assert rec.gain == 1.05
    assert rstore.ArtifactStore(str(tmp_path)).active("GPU-a").gain == 1.05
    with pytest.raises(ValueError):
        CalibrationRecord.from_json(json.dumps({"device_id": "x"}))
    with pytest.raises(ValueError):
        CalibrationRecord.from_json("[1, 2]")


def test_calibration_record_metadata_round_trip():
    rec = _rec(fitted_at=123.0, source="bench", note="rack 7")
    back = CalibrationRecord.from_json(rec.to_json())
    assert back == rec
    assert record_stamp(back) == 123.0 == rstore.record_stamp(_rrec(rec))
    assert record_stamp(dataclasses.replace(rec, fitted_at=None,
                                            created_at=77.0)) == 77.0


def _lifecycle(store, recs):
    """The same sequence of store operations, whichever package."""
    store.save(recs[0], activate=True)
    store.save(recs[1])
    store.save(recs[2], activate=True)
    store.save(recs[3], activate=True)
    store.activate(recs[0].device_id, 2)
    store.deactivate(recs[3].device_id)
    store.gc(max_age_s=50.0, now=1000.0)


def _store_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_store_files_are_the_references_byte_for_byte(tmp_path):
    recs = [_rec(gain=1.01, fitted_at=900.0),
            _rec(gain=1.02, fitted_at=990.0, source="bench", note="n"),
            _rec(device_id="node/7/GPU-b", gain=0.97),
            _rec(device_id="GPU-c", gain=None, fitted_at=10.0)]
    _lifecycle(ArtifactStore(str(tmp_path / "port")), recs)
    _lifecycle(rstore.ArtifactStore(str(tmp_path / "ref")),
               [_rrec(r) for r in recs])
    got, want = (_store_files(str(tmp_path / k)) for k in ("port", "ref"))
    assert sorted(got) == sorted(want)
    assert "active.json" in got and "devices/GPU-a/v0002.json" in got
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_written_by_one_is_read_by_the_other(tmp_path, writer):
    recs = [_rec(gain=1.01, fitted_at=900.0),
            _rec(gain=1.02, fitted_at=990.0),
            _rec(device_id="GPU-b", gain=0.97),
            _rec(device_id="GPU-c", gain=1.3)]
    root = str(tmp_path)
    if writer == "port":
        _lifecycle(ArtifactStore(root), recs)
        reader, mine = rstore.ArtifactStore(root), ArtifactStore(root)
    else:
        _lifecycle(rstore.ArtifactStore(root), [_rrec(r) for r in recs])
        reader, mine = ArtifactStore(root), rstore.ArtifactStore(root)
    assert reader.devices() == mine.devices() == ["GPU-a", "GPU-b", "GPU-c"]
    for dev in ("GPU-a", "GPU-b", "GPU-c"):
        a, b = reader.active(dev), mine.active(dev)
        assert (a is None) == (b is None), dev
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [i.summary() for i in reader.list_all()] == [
        i.summary() for i in mine.list_all()]


@pytest.mark.parametrize("baseline", [0.0, 12.5])
def test_resolve_corrections_matches_reference(tmp_path, baseline):
    root = str(tmp_path)
    store = ArtifactStore(root)
    store.save(_rec(device_id="GPU-0", gain=1.10, fitted_at=1000.0),
               activate=True)
    store.save(_rec(device_id="GPU-2", gain=0.95, fitted_at=10.0),
               activate=True)
    ids = ["GPU-0", "GPU-1", "GPU-2", "GPU-3"]
    for default in (None, _rec(device_id="*", gain=1.25)):
        for max_age in (None, 500.0):
            kw = dict(baseline_w=baseline, max_age_s=max_age, now=1200.0)
            corr, labels, n_act = resolve_corrections(
                ids, store=store, default=default, device=CPU, **kw)
            rcorr, rlabels, rn = rstore.resolve_corrections(
                ids, store=rstore.ArtifactStore(root),
                default=None if default is None else _rrec(default), **kw)
            assert n_act == rn
            np.testing.assert_array_equal(labels, rlabels)
            for f in dataclasses.fields(rcorr):
                np.testing.assert_array_equal(
                    getattr(corr, f.name).numpy(), getattr(rcorr, f.name),
                    err_msg=f.name)
    corr, labels, n_act = store.resolve(["GPU-0", "GPU-1"], device=CPU)
    assert n_act == 1 and list(labels) == ["a100", "uncalibrated"]
    assert corr.calibrated.tolist() == [True, False]


def test_resolve_corrections_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_corrections(["GPU-0"])


# ---------------------------------------------------------------------------
# end to end: the committed fixtures through the CLI
# ---------------------------------------------------------------------------

def _fixture_store(root, package="port"):
    rec = _rec(device_id=FIXTURE_UUIDS[0], gain=1.08, fitted_at=1.7e9)
    if package == "port":
        ArtifactStore(root).save(rec, activate=True)
    else:
        rstore.ArtifactStore(root).save(_rrec(rec), activate=True)


def test_fixture_replay_matches_direct_construction(tmp_path):
    """The daemon log through the CLI (hot-add growth, store-resolved
    corrections) equals the direct full-width construction bitwise."""
    _fixture_store(str(tmp_path / "store"))
    out_json = str(tmp_path / "out.json")
    rc = cli_main(["replay", DAEMON_FIXTURE,
                   "--store", str(tmp_path / "store"),
                   "--default-profile", "a100",
                   "--torch-device", "cpu", "--slab-samples", "512",
                   "--now", "1.7e9", "--json", out_json])
    assert rc == 0
    got = json.loads(open(out_json).read())
    assert got["wire"] == FIXTURE_EXPECT["daemon_sample.csv"]
    assert got["registry"]["uuids"] == FIXTURE_UUIDS
    assert got["pipeline"]["n_active_records"] == 1

    store = ArtifactStore(str(tmp_path / "store"))
    default = nominal_record("*", profiles.get("a100"))
    corr, labels, _ = resolve_corrections(FIXTURE_UUIDS, store=store,
                                          default=default, now=1.7e9,
                                          device=CPU)
    mon = MonitorService(5, corrections=corr, labels=labels,
                         strict_ids=False, device=CPU)
    asm = SlabAssembler(DeviceRegistry(FIXTURE_UUIDS), slab_samples=512)
    for batch in wire.iter_batches(DAEMON_FIXTURE):
        for dev, t, v in asm.push(batch):
            mon.ingest(dev, t, v)
    for dev, t, v in asm.flush():
        mon.ingest(dev, t, v)
    fleet = mon.fleet_energy()
    assert got["fleet_energy"]["corrected_j"] == fleet.total_j
    assert got["fleet_energy"]["raw_j"] == mon.fleet_energy(
        corrected=False).total_j
    assert got["fleet_energy"]["n_reporting"] == fleet.n_reporting
    assert got["fleet_energy"]["corrected_j"] != got["fleet_energy"]["raw_j"]
    assert got["pipeline"]["ingest"] == dict(mon.counters)


def _cli_pair(tmp_path, args_tail, store_pkg=None):
    """The port CLI on the CPU and the reference CLI on numpy, same
    arguments; returns both JSON outputs."""
    outs = []
    for name, main, dev_args in (
            ("port", cli_main, ["--torch-device", "cpu"]),
            ("ref", r_cli_main, ["--backend", "numpy"])):
        out_json = str(tmp_path / f"{name}.json")
        args = list(args_tail)
        if store_pkg is not None:
            root = str(tmp_path / f"store_{name}")
            _fixture_store(root, "port" if name == "port" else "ref")
            args += ["--store", root, "--now", "1.7e9"]
        assert main(args + dev_args + ["--json", out_json]) == 0
        outs.append(json.loads(open(out_json).read()))
    return outs


def _assert_cli_json_equal(got, want):
    assert set(got) == set(want)
    for key in ("log", "wire", "registry", "pipeline"):
        assert got[key] == want[key], key
    ge, we = got["fleet_energy"], want["fleet_energy"]
    assert set(ge) == set(we)
    for k in ("n_reporting", "coverage"):
        assert ge[k] == we[k], k
    for k in ("corrected_j", "raw_j", "sigma_independent_j",
              "sigma_worstcase_j"):
        assert ge[k] == pytest.approx(we[k], rel=J_RTOL, abs=0.0), k


@pytest.mark.parametrize("case", ["daemon_store", "daemon_frozen",
                                  "smi_rebase", "daemon_slabs"])
def test_cli_json_equals_the_reference_cli(tmp_path, case):
    if case == "daemon_store":
        tail, store = ["replay", DAEMON_FIXTURE, "--default-profile",
                       "a100"], "yes"
    elif case == "daemon_frozen":
        tail, store = ["replay", DAEMON_FIXTURE, "--frozen",
                       *FIXTURE_UUIDS[:4]], None
    elif case == "smi_rebase":
        tail, store = ["replay", SMI_FIXTURE, "--rebase",
                       "--default-profile", "h100_instant"], None
    else:
        tail, store = ["replay", DAEMON_FIXTURE, "--slab-samples", "100",
                       "--batch-rows", "33", "--baseline-w", "20"], None
    got, want = _cli_pair(tmp_path, tail, store)
    _assert_cli_json_equal(got, want)
    if case == "daemon_frozen":
        assert got["registry"]["n_rejected"] == 100
        assert got["pipeline"]["ingest"]["rejected"] == 100
    if case == "smi_rebase":
        assert got["wire"] == FIXTURE_EXPECT["smi_sample.csv"]
        assert got["fleet_energy"]["n_reporting"] == 4


def test_cli_calibrate_lifecycle(tmp_path, capsys):
    store_dir = str(tmp_path / "store")
    assert cli_main(["calibrate", "save", "--store", store_dir,
                     "--device", "GPU-a", "--profile", "a100",
                     "--gain", "1.1", "--activate"]) == 0
    assert cli_main(["calibrate", "save", "--store", store_dir,
                     "--device", "GPU-a", "--profile", "a100",
                     "--gain", "1.2"]) == 0
    capsys.readouterr()
    assert cli_main(["calibrate", "list", "--store", store_dir]) == 0
    listed = json.loads(capsys.readouterr().out)
    assert [a["version"] for a in listed["artifacts"]] == [1, 2]
    assert [a["active"] for a in listed["artifacts"]] == [True, False]
    assert cli_main(["calibrate", "activate", "--store", store_dir,
                     "--device", "GPU-a", "--version", "2"]) == 0
    assert ArtifactStore(store_dir).active("GPU-a").gain == 1.2
    assert rstore.ArtifactStore(store_dir).active("GPU-a").gain == 1.2
    assert cli_main(["calibrate", "activate", "--store", store_dir,
                     "--device", "GPU-a", "--version", "9"]) == 2
    assert cli_main(["calibrate", "gc", "--store", store_dir,
                     "--max-age-s", "1", "--dry-run"]) == 0
    assert cli_main(["calibrate", "deactivate", "--store", store_dir,
                     "--device", "GPU-a"]) == 0
    assert ArtifactStore(store_dir).active("GPU-a") is None


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def test_cli_help_subprocess():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.collect", "--help"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "python -m repro_torch.collect" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.collect", "replay", "--help"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0 and "--torch-device" in proc.stdout


def test_cli_smoke_subprocess():
    """``python -m repro_torch.collect replay`` as a subprocess on the
    CPU prints the JSON; without a card the default device refuses."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.collect", "replay",
         DAEMON_FIXTURE, "--torch-device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["wire"]["samples"] == \
        FIXTURE_EXPECT["daemon_sample.csv"]["samples"]
    assert got["fleet_energy"]["n_reporting"] == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cli_main(["replay", DAEMON_FIXTURE])
