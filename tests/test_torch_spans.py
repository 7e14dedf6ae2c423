"""The port's span and counter recorder (``repro_torch.common.spans``) and
the spans it records inside the ingest core and the fleet audit.

Recording is off unless a profiler runs or :func:`spans.enable` was
called; spans nest by thread, share their outermost span's id as
``root``, and past the bound are counted as dropped.  A monitor's grid,
dirty grid and flat slabs and a chunked audit with its prefetch worker
record the named span trees and read counts, and recording changes no
result.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import spans  # noqa: E402
from repro_torch.core.fleet_engine import fleet_audit  # noqa: E402
from repro_torch.core.load import FleetScenarioSpec  # noqa: E402
from repro_torch.core.stream import MonitorService  # noqa: E402
from repro_torch.core.stream import schema  # noqa: E402

CPU = "cpu"
N_DEV, M = 6, 12


@pytest.fixture(autouse=True)
def clean_recorder():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _names(rec):
    return sorted(s.name for s in rec.spans)


def _by_id(rec):
    return {s.id: s for s in rec.spans}


def _one(rec, name):
    got = [s for s in rec.spans if s.name == name]
    assert len(got) == 1, (name, _names(rec))
    return got[0]


# -- the recorder --------------------------------------------------------
def test_off_records_nothing_and_hands_back_one_shared_context():
    assert not spans.recording()
    assert spans.span("a") is spans.span("b") is spans.read("x.y")
    with spans.span("a"):
        with spans.read("x.y", 3):
            spans.count("c", 2)
    rec = spans.recorded()
    assert rec.spans == [] and rec.counters == {} and rec.dropped == 0


def test_records_under_a_cpu_profiler_inside_record_function():
    with torch.profiler.profile() as prof:
        assert spans.recording()
        with spans.span("outer"):
            with spans.read("layer.site", 2):
                torch.ones(3).sum()
            spans.count("layer.things")
    assert not spans.recording()
    rec = spans.recorded()
    assert _names(rec) == ["outer", "read.layer.site"]
    assert rec.counters == {"layer.host_reads": 2, "layer.things": 1}
    names = {e.name for e in prof.events()}
    assert {"outer", "read.layer.site"} <= names
    with spans.span("after"):       # the profiler has stopped
        pass
    assert len(spans.recorded().spans) == 2


def test_records_after_enable_and_stops_after_disable():
    spans.enable()
    with spans.span("a"):
        spans.count("k", 4)
    spans.disable()
    with spans.span("b"):
        spans.count("k")
    rec = spans.recorded()
    assert _names(rec) == ["a"] and rec.counters == {"k": 4}
    spans.reset()
    assert spans.recorded() == ([], {}, 0)


def test_parents_roots_and_threads():
    spans.enable()
    seen = {}

    def worker():
        seen["thread"] = threading.get_ident()
        with spans.span("w.outer"):
            with spans.span("w.inner"):
                seen["current"] = spans.current()

    with spans.span("a"):
        with spans.span("b"):
            with spans.span("c"):
                assert spans.current() == "c"
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        with spans.span("d"):
            pass
    with spans.span("e"):
        pass
    assert spans.current() is None
    rec = spans.recorded()
    a, b, c, d, e = (_one(rec, x) for x in "abcde")
    assert a.parent is None and a.root == a.id
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert b.root == c.root == d.root == a.id
    assert e.parent is None and e.root == e.id != a.id
    main = threading.get_ident()
    assert {a.thread, b.thread, c.thread, d.thread, e.thread} == {main}
    wo, wi = _one(rec, "w.outer"), _one(rec, "w.inner")
    assert seen["current"] == "w.inner"
    assert wo.thread == wi.thread == seen["thread"] != main
    assert wo.parent is None and wo.root == wo.id
    assert wi.parent == wo.id and wi.root == wo.id
    for s in rec.spans:
        assert s.t0_ns <= s.t1_ns
    assert a.t0_ns <= b.t0_ns <= c.t0_ns <= c.t1_ns <= b.t1_ns <= a.t1_ns


def test_drops_past_the_bound_and_counts_them(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    spans.enable()
    for i in range(5):
        with spans.span(f"s{i}"):
            spans.count("n")
    rec = spans.recorded()
    assert len(rec.spans) == 3 and rec.dropped == 2
    assert rec.counters == {"n": 5}


# -- the ingest core -----------------------------------------------------
def _monitor():
    labels = np.array(["train", "infer", "idle"] * (N_DEV // 3),
                      dtype=object)
    return MonitorService(N_DEV, labels=labels, ring_slots=4, device=CPU)


def _grid_slab(k, dirty=False):
    g = torch.Generator().manual_seed(k)
    ts = 0.001 * torch.arange(k * M + 1, (k + 1) * M + 1, dtype=torch.float64)
    vals = 100.0 + 50.0 * torch.rand((N_DEV, M), generator=g,
                                     dtype=torch.float64)
    if dirty:
        vals[2, 5] = float("nan")
    return torch.arange(N_DEV), ts, vals


def _flat_slab(k):
    dev, ts, vals = _grid_slab(k)
    d = dev.repeat_interleave(M)
    t = ts.repeat(N_DEV)
    order = torch.randperm(d.numel(), generator=torch.Generator()
                           .manual_seed(100 + k))
    # one sample sent twice: a duplicate the flat path drops
    order = torch.cat([order, order[:1]])
    return d[order], t[order], vals.reshape(-1)[order]


def _feed(mon):
    mon.ingest_grid(*_grid_slab(0))
    mon.ingest_grid(*_grid_slab(1, dirty=True))
    mon.ingest(*_flat_slab(2))


def _phases(rec, top):
    return [s.name for s in sorted(rec.spans, key=lambda s: s.t0_ns)
            if s.parent == top.id]


def test_a_clean_grid_slab_records_its_phases_and_reads():
    mon = _monitor()
    mon.ingest_grid(*_grid_slab(0))
    spans.enable()
    mon.ingest_grid(*_grid_slab(1))
    rec = spans.recorded()
    top = _one(rec, "ingest.grid")
    assert top.parent is None
    assert {s.root for s in rec.spans} == {top.id}
    assert _phases(rec, top) == ["ingest.prep", "ingest.prep",
                                 "ingest.kernel", "ingest.fold",
                                 "ingest.moments"]
    byid = _by_id(rec)
    reads = {s.name: byid[s.parent].name for s in rec.spans
             if s.name.startswith("read.")}
    assert reads == {"read.ingest.ids": "ingest.prep",
                     "read.ingest.clean": "ingest.prep",
                     "read.ingest.has": "ingest.fold",
                     "read.ingest.runs": "ingest.fold",
                     "read.ingest.moments": "ingest.moments"}
    # ids, clean, the has flag, the two run masks, the moments
    assert rec.counters == {"ingest.host_reads": 6}


def test_a_dirty_grid_slab_falls_back_under_the_grid_span():
    mon = _monitor()
    mon.ingest_grid(*_grid_slab(0))
    spans.enable()
    mon.ingest_grid(*_grid_slab(1, dirty=True))
    rec = spans.recorded()
    top = _one(rec, "ingest.grid")
    flat = _one(rec, "ingest.flat")
    assert flat.parent == top.id and flat.root == top.id
    assert _phases(rec, top) == ["ingest.prep", "ingest.flat"]
    assert _phases(rec, flat) == ["ingest.prep", "ingest.kernel",
                                  "ingest.fold", "ingest.moments"]
    assert rec.counters["ingest.fallbacks"] == 1
    # grid: ids, clean; flat: ids, finite, its mask, dups, keep (3),
    # groups, ring (6), has, runs (2), moments
    assert rec.counters["ingest.host_reads"] == 2 + 1 + 1 + 3 + 1 + 3 + 1 \
        + 6 + 1 + 2 + 1


def test_a_flat_slab_records_its_phases_and_reads():
    mon = _monitor()
    mon.ingest_grid(*_grid_slab(0))
    spans.enable()
    mon.ingest(*_flat_slab(1))
    rec = spans.recorded()
    top = _one(rec, "ingest.flat")
    assert top.parent is None
    assert _phases(rec, top) == ["ingest.prep", "ingest.kernel",
                                 "ingest.fold", "ingest.moments"]
    sites = sorted(s.name for s in rec.spans if s.name.startswith("read."))
    assert sites == sorted(["read.ingest.ids", "read.ingest.finite",
                            "read.ingest.dups", "read.ingest.dups",
                            "read.ingest.keep", "read.ingest.groups",
                            "read.ingest.ring", "read.ingest.has",
                            "read.ingest.runs", "read.ingest.moments"])
    # ids, finite, dups, the duplicate's mask, keep (3), groups, ring (6),
    # has, runs (2), moments; the prep's drops (the slab's one duplicate)
    assert rec.counters == {"ingest.host_reads": 18,
                            "ingest.dropped.rejected": 0,
                            "ingest.dropped.invalid": 0,
                            "ingest.dropped.duplicates": 1,
                            "ingest.dropped.late": 0}


def _state(mon):
    arrays = {}
    for obj, fields in ((mon.state, schema.DEVICE_STATE_FIELDS),
                        (mon.ring, schema.RING_FIELDS),
                        (mon.core.periods, ("counts", "sums"))):
        for f in fields:
            arrays[f] = getattr(obj, f).clone()
    return arrays, mon.counters, mon.reading_stats()


def test_recording_leaves_the_monitor_bitwise_as_it_was():
    off = _monitor()
    _feed(off)
    on = _monitor()
    spans.enable()
    _feed(on)
    a_off, c_off, m_off = _state(off)
    a_on, c_on, m_on = _state(on)
    assert c_on == c_off and m_on == m_off
    for k in a_off:
        assert torch.equal(a_on[k], a_off[k]), k



# -- the health machine's phase and the drop counters ---------------------
DROPPED = ("ingest.dropped.rejected", "ingest.dropped.invalid",
           "ingest.dropped.duplicates", "ingest.dropped.late")


def _hardened(health=True):
    from repro_torch.core.stream import HealthPolicy
    labels = np.array(["train", "infer", "idle"] * (N_DEV // 3),
                      dtype=object)
    return MonitorService(N_DEV, labels=labels, ring_slots=4,
                          strict_ids=False,
                          health=HealthPolicy() if health else None,
                          health_every_s=0.5, silent_after_s=1.0,
                          device=CPU)


def _dirty_flat_slab(k):
    """A flat slab with one duplicate (from ``_flat_slab``), one
    out-of-range id, one NaN reading and one sample older than the
    device's newest accepted one."""
    dev, t, v = _flat_slab(k)
    dev, t, v = dev.clone(), t.clone(), v.clone()
    dev[1] = N_DEV + 2
    v[2] = float("nan")
    late = torch.tensor([0.0005])
    return (torch.cat([dev, torch.tensor([dev[3]])]), torch.cat([t, late]),
            torch.cat([v, torch.tensor([100.0])]))


@pytest.mark.parametrize("health", [True, False], ids=["health", "no_health"])
def test_the_health_phase_and_drop_counters_only_with_health(health):
    """The phase ``ingest.health`` comes with a health policy; the drop
    counters are the prep's and come either way."""
    mon = _hardened(health)
    mon.ingest_grid(*_grid_slab(0))
    spans.enable()
    rep = mon.ingest(*_dirty_flat_slab(1))
    rec = spans.recorded()
    assert (rep.rejected, rep.invalid, rep.duplicates, rep.late) == (
        1, 1, 1, 1)
    top = _one(rec, "ingest.flat")
    phases = ["ingest.prep", "ingest.kernel", "ingest.fold",
              "ingest.moments"]
    byid = _by_id(rec)
    if health:
        assert _phases(rec, top) == phases + ["ingest.health"]
        assert byid[_one(rec, "read.ingest.health").parent].name == \
            "ingest.health"
    else:
        assert _phases(rec, top) == phases
        assert not any(s.name.endswith("health") for s in rec.spans)
    assert {k: rec.counters[k] for k in DROPPED} == dict.fromkeys(DROPPED, 1)
    # ids, their mask (4), finite, its mask (3), dups, the duplicate's
    # mask, the late one's mask, keep (3), groups, ring (6), has, runs (2),
    # moments; with health the step's clock: the counters add no read
    assert rec.counters["ingest.host_reads"] == 1 + 4 + 1 + 3 + 1 + 1 + 1 \
        + 3 + 1 + 6 + 1 + 2 + 1 + (1 if health else 0)


def test_a_grid_slab_runs_the_health_step_in_its_own_phase():
    mon = _hardened()
    mon.ingest_grid(*_grid_slab(0))
    spans.enable()
    dev, ts, vals = _grid_slab(1)
    rep = mon.ingest_grid(torch.cat([dev, torch.tensor([N_DEV])]), ts,
                          torch.cat([vals, vals[:1]]))
    rec = spans.recorded()
    assert rep.rejected == M
    top = _one(rec, "ingest.grid")
    assert _phases(rec, top) == ["ingest.prep", "ingest.prep",
                                 "ingest.kernel", "ingest.fold",
                                 "ingest.moments", "ingest.health"]
    assert rec.counters["ingest.dropped.rejected"] == M
    # ids (1 + 3 for the rejection), clean (with the health clock), has,
    # runs (2), moments: the health step reads nothing of its own here
    assert rec.counters["ingest.host_reads"] == 4 + 1 + 1 + 2 + 1


def test_recording_leaves_the_hardened_monitor_bitwise_as_it_was():
    off, on = _hardened(), _hardened()
    for mon in (off, on):
        if mon is on:
            spans.enable()
        mon.ingest_grid(*_grid_slab(0))
        mon.ingest(*_dirty_flat_slab(1))
        mon.ingest_grid(*_grid_slab(2, dirty=True))
    assert on.counters == off.counters
    for k in ("code", "since_t", "n_quarantines"):
        assert torch.equal(getattr(on.health, k), getattr(off.health, k)), k
    for f in schema.DEVICE_STATE_FIELDS:
        assert torch.equal(getattr(on.state, f), getattr(off.state, f)), f


# -- the fleet audit -----------------------------------------------------
N_AUDIT, CHUNK = 600, 200
NAMES = ["a100", "a100", "h100_instant", "v100"] * (N_AUDIT // 4)


def _audit():
    spec = FleetScenarioSpec(N_AUDIT, seed=11)
    return fleet_audit(N_AUDIT, NAMES, workload=spec, seed=11,
                       good_practice=True, n_trials=2, chunk_devices=CHUNK,
                       prefetch_workloads=True, device=CPU)


def test_a_chunked_audit_records_its_phases_and_the_worker_reads():
    spans.enable()
    _audit()
    rec = spans.recorded()
    top = _one(rec, "audit.run")
    main = threading.get_ident()
    assert top.parent is None and top.thread == main
    slabs = N_AUDIT // CHUNK
    assert _phases(rec, top) == ["audit.bank"] + [
        "audit.synth_wait", "audit.measure", "audit.moments"] * slabs
    on_main = [s for s in rec.spans if s.thread == main]
    assert all(s.root == top.id for s in on_main)
    worker = [s for s in rec.spans if s.thread != main]
    # the prefetch worker synthesises every slab on its own
    # thread, with its own stack: its reads are its own roots
    assert worker and all(s.name.startswith("read.audit.") for s in worker)
    assert all(s.parent is None and s.root == s.id for s in worker)
    assert all(s.name.startswith("read.audit.") or s.name.startswith(
        "audit.") for s in rec.spans)
    assert set(rec.counters) == {"audit.host_reads"}
    assert rec.counters["audit.host_reads"] >= sum(
        1 for s in rec.spans if s.name.startswith("read."))


def test_recording_leaves_the_audit_bitwise_as_it_was():
    off = _audit()
    spans.enable()
    on = _audit()
    for key in ("naive_j", "naive_err", "gp_j", "gp_err", "true_j"):
        assert torch.equal(getattr(on, key), getattr(off, key)), key
    assert on.streamed == off.streamed
    assert list(on.scenarios) == list(off.scenarios)
