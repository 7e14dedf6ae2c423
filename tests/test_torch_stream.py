"""The port's streaming monitor and query service against the JAX
package's, on the numpy reference tier.

``repro_torch`` ``MonitorService(device="cpu")`` and ``repro``
``MonitorService(backend="numpy")`` take the same slabs; their states
must agree bitwise on counters, run tracking, flags and timestamps and
to rtol = atol = 1e-12 on energies.  Float sums that the port reorders
(the period histograms' ``index_put_``) are held to 1e-12 too: on the
CPU they add in index order, as ``np.add.at`` does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from test_backend_parity import (ADVERSARIAL_CASES,  # noqa: E402
                                 _adversarial_stream)
from test_serving import _corr, _query_fingerprint, _slabs  # noqa: E402

from repro.core.stream import MonitorService as RMonitor  # noqa: E402
from repro.core.stream import schema  # noqa: E402
from repro.serve.monitor_service import (  # noqa: E402
    MonitorQuery as RQuery, MonitorQueryService as RService)
from repro_torch import convert  # noqa: E402
from repro_torch.core.stream import HealthPolicy, MonitorService  # noqa: E402
from repro_torch.serve.monitor_service import (  # noqa: E402
    MonitorQuery, MonitorQueryService)

RTOL = ATOL = 1e-12
CPU = "cpu"


def _pair(n, seed=None, **kw):
    """A reference monitor and a port monitor with the same settings."""
    if seed is not None:
        rc = _corr(n, seed)
        kw_r = dict(kw, corrections=rc)
        kw_t = dict(kw, corrections=convert.stream_corrections(
            dataclasses.asdict(rc), device=CPU))
    else:
        kw_r = kw_t = kw
    return RMonitor(n, backend="numpy", **kw_r), MonitorService(
        n, device=CPU, **kw_t)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_state(ref, port, label=""):
    """Every array of the online state, plus counters and moments."""
    assert ref.counters == port.counters, label
    ra, _ = schema.pack_monitor(ref)
    ta = convert.monitor_arrays(port)
    for key, b in ta.items():
        a = ra[key]
        assert a.shape == b.shape, f"{label} {key}"
        if a.dtype == np.float64 and key.split(".")[1] in (
                "energy_j", "energy_corr_j", "win_j", "win_corr_j",
                "ewma_w", "e_raw", "e_corr", "sums", "mean", "m2",
                "mean_abs"):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{label} {key}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{label} {key}")
    np.testing.assert_allclose(_np(port.update_period_s()),
                               ref.update_period_s(), rtol=RTOL,
                               equal_nan=True, err_msg=label)


def _fingerprints_close(fr, ft, label=""):
    assert set(fr) == set(ft), label
    for k in fr:
        a, b = np.asarray(fr[k]), _np(ft[k])
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=f"{label} {k}")


# ---------------------------------------------------------------------------
# the adversarial streams of the reference's parity harness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ADVERSARIAL_CASES)
def test_monitor_adversarial_stream_matches_reference(case):
    kw = dict(max_hold_s=0.5, envelope_w=(0.0, 300.0), ring_slots=4)
    ref, port = _pair(6, **kw)
    ref.set_windows(np.full(6, 0.15), np.full(6, 0.45))
    port.set_windows(np.full(6, 0.15), np.full(6, 0.45))
    slabs_r = _adversarial_stream(case, np.random.default_rng(123))
    slabs_t = _adversarial_stream(case, np.random.default_rng(123))
    for (dr, tr, vr), (dt, tt, vt) in zip(slabs_r, slabs_t):
        rep_r = ref.ingest(dr, tr, vr)
        rep_t = port.ingest(dt, tt, vt)
        assert dataclasses.asdict(rep_r) == dataclasses.asdict(rep_t), case
    assert_same_state(ref, port, case)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**32 - 1))
def test_property_monitor_chaotic_stream_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = _pair(6, max_hold_s=0.5, envelope_w=(0.0, 300.0),
                      ring_slots=4)
    ref.set_windows(np.full(6, 0.2), np.full(6, 1.4))
    port.set_windows(np.full(6, 0.2), np.full(6, 1.4))
    for _ in range(3):
        k = int(rng.integers(1, 60))
        dev = rng.integers(0, 6, k)
        t = rng.uniform(0.0, 2.0, k)
        v = rng.uniform(40.0, 320.0, k)
        v[rng.random(k) < 0.08] = np.nan
        t[rng.random(k) < 0.04] = np.inf
        ref.ingest(dev.copy(), t.copy(), v.copy())
        port.ingest(dev, t, v)
    assert_same_state(ref, port, f"seed={seed}")


def test_duplicates_keep_the_first_arrival_whatever_the_order():
    """Equal (device, t) with different readings: the first arrival wins,
    so the sort must be stable."""
    dev = np.array([1, 0, 0, 1, 0, 1])
    t = np.array([0.2, 0.1, 0.1, 0.2, 0.3, 0.1])
    v = np.array([110.0, 100.0, 999.0, 777.0, 105.0, 90.0])
    ref, port = _pair(2, ring_slots=4)
    assert dataclasses.asdict(ref.ingest(dev, t, v)) == \
        dataclasses.asdict(port.ingest(dev, t, v))
    assert_same_state(ref, port)
    assert port.state.last_v.tolist() == [105.0, 110.0]


@pytest.mark.parametrize("integration", ["rectangle", "trapezoid"])
@pytest.mark.parametrize("ring_slots", [0, 3])
def test_messy_slabs_match_reference(integration, ring_slots):
    kw = dict(labels=np.array(["train", "serve", "idle"],
                              dtype=object)[np.arange(9) % 3],
              max_hold_s=2.0, ring_slots=ring_slots, integration=integration)
    ref, port = _pair(9, seed=4, **kw)
    ref.set_windows(0.5, 2.5)
    port.set_windows(0.5, 2.5)
    for dev, t, v in _slabs(9, n_slabs=5, seed=2):
        ref.ingest(dev, t, v)
        port.ingest(dev, t, v)
    assert_same_state(ref, port)
    _fingerprints_close(_query_fingerprint(ref), _query_fingerprint(port))


def _messier(slab, rng, n):
    """A messy slab with what the grouping must drop or keep: -0.0 next
    to +0.0, non-finite samples, ids out of range, repeats of a slab
    ago's times (late or a repeat of the stored newest)."""
    dev, t, v = (np.array(x, copy=True) for x in slab)
    k = dev.size
    t[rng.random(k) < 0.03] = np.nan
    v[rng.random(k) < 0.03] = np.inf
    dev[rng.random(k) < 0.03] = n + 1
    old = rng.random(k) < 0.05
    t[old] -= 0.5
    extra = np.arange(4) % n
    return (np.r_[dev, extra, extra], np.r_[t, np.zeros(4), -np.zeros(4)],
            np.r_[v, np.arange(4.0), 10.0 + np.arange(4.0)])


@pytest.mark.parametrize("ring_slots", [0, 3])
def test_flat_ingest_through_stream_groups_plain_version(ring_slots,
                                                         monkeypatch):
    """``IngestCore.ingest`` on CPU tensors groups each slab through
    ``stream_group``'s plain version and gives the reports and state of
    the prep it replaced, the reference's, on the messy slabs made
    messier; an empty and an all-dropped slab too."""
    from repro_torch.core.stream import ingest as ingest_mod
    from repro_torch.kernels import stream_group as ksg
    calls = []

    def plain(*args):
        calls.append(args[0].device.type)
        return ksg.stream_group(*args)

    monkeypatch.setattr(ingest_mod, "stream_group", plain)
    kw = dict(max_hold_s=2.0, ring_slots=ring_slots, strict_ids=False)
    ref, port = _pair(9, seed=4, **kw)
    rng = np.random.default_rng(11)
    slabs = [_messier(s, rng, 9) for s in _slabs(9, n_slabs=5, seed=2)]
    slabs += [(np.zeros(0, np.int64), np.zeros(0), np.zeros(0)),
              slabs[-1]]                  # all dropped: sent again
    for dev, t, v in slabs:
        rep_r = ref.ingest(dev.copy(), t.copy(), v.copy())
        rep_t = port.ingest(dev, t, v)
        assert dataclasses.asdict(rep_r) == dataclasses.asdict(rep_t)
    assert rep_t.accepted == 0 and rep_t.duplicates + rep_t.late > 0
    assert calls == ["cpu"] * len(slabs)
    assert_same_state(ref, port)


# ---------------------------------------------------------------------------
# grid path vs flat path, and the dirty-slab fallback
# ---------------------------------------------------------------------------
def _grid_slabs(rng, d, n_slabs, m):
    t0 = 0.0
    out = []
    for _ in range(n_slabs):
        ts = t0 + np.cumsum(rng.uniform(0.001, 0.05, m))
        v = np.round(rng.uniform(60.0, 250.0, (d, m)) / 10.0) * 10.0
        out.append((np.arange(d), ts, v))
        t0 = float(ts[-1])
    return out


def test_monitor_grid_path_matches_flat_path_and_reference():
    rng = np.random.default_rng(8)
    slabs = _grid_slabs(rng, 5, 4, 30)
    labels = np.array(["a", "b"], dtype=object)[np.arange(5) % 2]
    mons = {}
    for grid in (False, True):
        ref, port = _pair(5, seed=1, labels=labels, ring_slots=6)
        for mon in (ref, port):
            mon.set_windows(0.2, 1.5)
            for dev, ts, v in slabs:
                if grid:
                    mon.ingest_grid(dev, ts, v)
                else:
                    mon.ingest(np.repeat(dev, len(ts)),
                               np.tile(ts, len(dev)), v.ravel())
        assert_same_state(ref, port, f"grid={grid}")
        mons[grid] = port
    flat, grid = mons[False], mons[True]
    assert flat.counters == grid.counters
    for name in ("energy_j", "energy_corr_j", "win_j", "win_corr_j"):
        torch.testing.assert_close(getattr(grid.state, name),
                                   getattr(flat.state, name), rtol=1e-11,
                                   atol=1e-11)
    for name in ("n_changes", "run_t", "n_out", "n_samples"):
        assert torch.equal(getattr(grid.state, name),
                           getattr(flat.state, name))
    for name in ("t", "v", "e_raw", "e_corr"):
        torch.testing.assert_close(getattr(grid.ring, name),
                                   getattr(flat.ring, name), rtol=1e-11,
                                   atol=1e-11)


def test_monitor_grid_path_falls_back_on_dirty_slabs():
    ref, port = _pair(3)
    ts = np.array([0.1, 0.2, 0.3])
    vals = np.full((3, 3), 100.0)
    vals[1, 1] = np.nan
    for mon in (ref, port):
        rep = mon.ingest_grid(np.arange(3), ts, vals)
        assert rep.invalid == 1 and rep.accepted == 8
        rep2 = mon.ingest_grid(np.arange(3), ts, np.full((3, 3), 100.0))
        assert rep2.accepted == 0
        assert rep2.duplicates == 3 and rep2.late == 6
        assert mon.counters["accepted"] == 8
    assert_same_state(ref, port)


def test_grid_ids_out_of_range_rejected_or_raised():
    ref, port = _pair(3, strict_ids=False)
    vals = np.arange(12.0).reshape(4, 3) + 50.0
    for mon in (ref, port):
        rep = mon.ingest_grid(np.array([0, 1, 2, 7]), [0.1, 0.2, 0.3], vals)
        assert rep.rejected == 3 and rep.accepted == 9
    assert_same_state(ref, port)
    strict = MonitorService(3, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        strict.ingest([0, 5], [0.1, 0.2], [1.0, 2.0])


# ---------------------------------------------------------------------------
# snapshots and the query service
# ---------------------------------------------------------------------------
def test_snapshot_unchanged_by_later_ingestion():
    port = MonitorService(9, device=CPU, ring_slots=8, max_hold_s=2.0,
                          labels=np.array(["x", "y", "z"],
                                          dtype=object)[np.arange(9) % 3])
    port.set_windows(0.5, 2.5)
    slabs = _slabs(9, n_slabs=6, seed=3)
    for dev, t, v in slabs[:3]:
        port.ingest(dev, t, v)
    snap = port.snapshot()
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in _query_fingerprint(snap).items()}
    for dev, t, v in slabs[3:]:
        port.ingest(dev, t, v)
    after = _query_fingerprint(snap)
    for k in before:
        a, b = before[k], after[k]
        if isinstance(a, torch.Tensor):
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert port.snapshot().epoch > snap.epoch
    assert port.fleet_energy().total_j > float(before["fleet_total"])


def _queries(cls):
    return [cls.fleet_energy(1.7), cls.fleet_energy(None),
            cls.fleet_energy(1.7, corrected=False),
            cls.window_energy(1.8), cls.window_energy(None),
            cls.window_energy(0.4, corrected=False),
            cls.energy_between(0.9, 1.9), cls.energy_between(1.0, 1.0),
            cls.by_label(), cls.by_label(1.2, 1.9),
            cls.fleet_energy(1.7)]            # a duplicate in the batch


def _answer_fields(x):
    if isinstance(x, tuple):
        return {str(i): v for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {f"{k}.{m}": np.float64(v) for k, d in x.items()
                for m, v in d.items()}
    if dataclasses.is_dataclass(x):
        return {k: v for k, v in dataclasses.asdict(x).items()
                if v is not None}
    return {"": x}


def test_query_service_answers_match_reference():
    ref, port = _pair(9, seed=2, max_hold_s=2.0, ring_slots=8,
                      labels=np.array(["train", "serve", "idle"],
                                      dtype=object)[np.arange(9) % 3])
    ref.set_windows(0.5, 2.5)
    port.set_windows(0.5, 2.5)
    for dev, t, v in _slabs(9, n_slabs=4, seed=6):
        ref.ingest(dev, t, v)
        port.ingest(dev, t, v)
    rs, ts = RService(ref), MonitorQueryService(port)
    got_r = rs.query_many(_queries(RQuery))
    got_t = ts.query_many(_queries(MonitorQuery))
    for i, (a, b) in enumerate(zip(got_r, got_t)):
        _fingerprints_close(_answer_fields(a), _answer_fields(b), f"q{i}")
    assert ts.stats() == rs.stats()
    # the direct path gives the same answers as the executor
    _fingerprints_close(_answer_fields(port.fleet_energy(1.7)),
                        _answer_fields(got_t[0]))


def test_query_service_cache_is_keyed_by_epoch():
    port = MonitorService(4, device=CPU, ring_slots=4)
    slabs = _slabs(4, n_slabs=2, seed=1)
    port.ingest(*slabs[0])
    svc = MonitorQueryService(port, cache_size=8)
    q = MonitorQuery.fleet_energy(None)
    first = svc.query(q)
    assert svc.query(q) is first and svc.stats()["cache_hits"] == 1
    port.ingest(*slabs[1])
    second = svc.query(q)
    assert second is not first and second.total_j > first.total_j
    with pytest.raises(ValueError):
        MonitorQuery.energy_between(2.0, 1.0)
    with pytest.raises(TypeError):
        svc.submit("fleet_energy")


# ---------------------------------------------------------------------------
# configuration edges and the state carried across by convert.py
# ---------------------------------------------------------------------------
def test_configuration_edges():
    with pytest.raises(ValueError, match="stale_factor"):
        MonitorService(3, device=CPU,
                       health=HealthPolicy(stale_factor=0.0))
    with pytest.raises(ValueError):
        MonitorService(3, device=CPU, integration="simpson")
    port = MonitorService(3, device=CPU)
    port.ingest([0], [0.1], [100.0])
    with pytest.raises(RuntimeError, match="before the first ingest"):
        port.set_windows(0.0, 1.0)
    with pytest.raises(ValueError):
        port.energy_between(2.0, 1.0)
    assert port.nbytes() > 0


def test_state_carried_across_continues_like_the_reference():
    """Load a reference monitor's state mid-stream with convert.py, then
    both continue on the same slabs and stay equal."""
    labels = np.array(["train", "serve", "idle"], dtype=object)[
        np.arange(9) % 3]
    ref, port = _pair(9, seed=3, labels=labels, ring_slots=8,
                      max_hold_s=2.0)
    ref.set_windows(0.5, 2.5)
    port.set_windows(0.5, 2.5)
    slabs = _slabs(9, n_slabs=6, seed=5)
    for dev, t, v in slabs[:3]:
        ref.ingest(dev, t, v)
    arrays, meta = schema.pack_monitor(ref)
    convert.load_monitor_state(port, arrays, meta["moment_labels"])
    assert_same_state(ref, port, "loaded")
    for dev, t, v in slabs[3:]:
        ref.ingest(dev, t, v)
        port.ingest(dev, t, v)
    assert_same_state(ref, port, "continued")
    back = convert.corrections_to_numpy(port.corrections)
    for k, a in dataclasses.asdict(ref.corrections).items():
        np.testing.assert_array_equal(back[k], a)
