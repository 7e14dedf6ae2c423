"""The port's health machine, degraded-mode queries, ``grow`` and
crash-recovery supervisor against the JAX package's numpy tier.

``repro_torch`` monitors run with ``device="cpu"``; the reference's with
``backend="numpy"`` (its ``"auto"`` resolves to the jax tier, which does
not import under jax 0.9).  Health codes, flags, counters and health
summaries must equal the reference's bitwise; energies, coverage and
widened sigmas to rtol 1e-12.  Port-to-port comparisons (grow against
up-front construction, supervised recovery against an uninterrupted run)
are bitwise throughout.  Each package's monitor takes the faulted
stream of its own ``FaultInjector`` (the port's on tensors, the
reference's on numpy arrays) from the same input slabs;
``test_both_injectors_emit_the_same_slabs`` holds the two streams
bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_resilience import (ALL_FAULTS, _crashing,  # noqa: E402
                             _faulty_source, _fingerprint, _slabs, _steady)
from test_serving import _corr  # noqa: E402

from repro.core.stream import FaultInjector as RInjector  # noqa: E402
from repro.core.stream import FaultSpec as RSpec  # noqa: E402
from repro.core.stream import HealthPolicy as RPolicy  # noqa: E402
from repro.core.stream import MonitorService as RMonitor  # noqa: E402
from repro.core.stream.health import HealthTracker as RTracker  # noqa: E402
from repro.core.stream.state import DeviceState as RState  # noqa: E402
from repro.serve.monitor_service import (  # noqa: E402
    MonitorQuery as RQuery, MonitorQueryService as RService)
from repro_torch import convert  # noqa: E402
from repro_torch.core.stream import (QUARANTINED, STALE,  # noqa: E402
                                     FaultInjector, FaultSpec, HealthPolicy,
                                     HealthTracker, MonitorService,
                                     MonitorSupervisor, StreamCorrections)
from repro_torch.core.stream.state import DeviceState  # noqa: E402
from repro_torch.serve.monitor_service import (  # noqa: E402
    MonitorQuery, MonitorQueryService)

RTOL = ATOL = 1e-12
CPU = "cpu"
LABELS3 = np.array(["train", "serve", "idle"], dtype=object)
HEALTH_FIELDS = ("code", "since_t", "clean_t", "clean", "last_n_out",
                 "n_quarantines")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _exact_key(k):
    """Fingerprint entries compared bitwise: codes, flags, counts,
    coverage; the rest are float energies and sigmas."""
    return (k.startswith(("counters.", "health.", "flags."))
            or k in ("fleet_covered", "between_cov", "fleet_n_q",
                     "fleet_coverage")
            or k.split(".")[-1] in ("n_devices", "n_covered",
                                    "n_quarantined"))


def assert_fingerprints_match(fr, ft, label=""):
    """Reference fingerprint ``fr`` against the port's ``ft``."""
    assert set(fr) == set(ft), label
    for k in fr:
        a, b = np.asarray(fr[k]), _np(ft[k])
        if _exact_key(k) or a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=f"{label} {k}")


def assert_fingerprints_equal(a, b, label=""):
    """Two port fingerprints, bitwise."""
    assert set(a) == set(b), label
    for k in a:
        np.testing.assert_array_equal(_np(a[k]), _np(b[k]),
                                      err_msg=f"{label} {k}")


def assert_arrays_equal(a, b, label=""):
    """Two ``convert.monitor_arrays`` dicts, bitwise."""
    assert set(a) == set(b), label
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label} {k}")


def _pair(n, seed=None, labels=None, windows=None, **kw):
    """A reference and a port monitor with the same settings."""
    kw_r, kw_t = dict(kw), dict(kw)
    if seed is not None:
        rc = _corr(n, seed)
        kw_r["corrections"] = rc
        kw_t["corrections"] = convert.stream_corrections(
            dataclasses.asdict(rc), device=CPU)
    if labels is not None:
        kw_r["labels"] = kw_t["labels"] = labels
    pol = kw.get("health")
    if pol is not None:
        kw_r["health"] = RPolicy(**dataclasses.asdict(pol))
    ref = RMonitor(n, backend="numpy", **kw_r)
    port = MonitorService(n, device=CPU, **kw_t)
    if windows is not None:
        ref.set_windows(*windows)
        port.set_windows(*windows)
    return ref, port


def _both_monitors(n, seed=0, **kw):
    """The pair ``test_resilience._monitor`` builds."""
    return _pair(n, seed=seed, labels=LABELS3[np.arange(n) % 3],
                 windows=(0.5, 2.5), max_hold_s=2.0, ring_slots=8, **kw)


def assert_same_health(ref, port, label=""):
    for k in HEALTH_FIELDS:
        np.testing.assert_array_equal(_np(getattr(port.health, k)),
                                      getattr(ref.health, k),
                                      err_msg=f"{label} health.{k}")
    assert port.counters == ref.counters, label
    assert port.health_summary() == ref.health_summary(), label
    assert port.epoch == ref.epoch, label


# ---------------------------------------------------------------------------
# HealthTracker.update on seeded random state
# ---------------------------------------------------------------------------
def _random_health_case(seed):
    """Random state arrays with every edge the step branches on: never
    reporting devices, dur == 0, fresh anomalies, drift, nan estimates."""
    rng = np.random.default_rng(seed)
    n = 64
    has = rng.random(n) < 0.85
    first_t = rng.uniform(0.0, 50.0, n)
    last_t = first_t + rng.choice([0.0, 0.5, 30.0, 90.0], n)
    dur = last_t - first_t
    energy = rng.uniform(50.0, 300.0, n) * np.where(dur > 0, dur, 1.0)
    ewma = energy / np.where(dur > 0, dur, 1.0) * rng.choice(
        [1.0, 1.01, 1.6, 0.2], n)
    n_out = rng.integers(0, 4, n)
    st = dict(last_t=last_t, last_v=rng.uniform(0, 300, n), has=has,
              first_t=first_t, n_samples=rng.integers(1, 100, n),
              n_dup=np.zeros(n, np.int64), n_late=np.zeros(n, np.int64),
              energy_j=energy, energy_corr_j=energy, win_j=energy,
              win_corr_j=energy, run_t=last_t,
              n_changes=rng.integers(0, 9, n), ewma_w=ewma,
              n_out=n_out.astype(np.int64))
    tracker = dict(
        code=rng.integers(0, 3, n).astype(np.int8),
        since_t=rng.uniform(0, 50, n), clean_t=rng.uniform(0, 100, n),
        clean=rng.random(n) < 0.5,
        last_n_out=np.maximum(n_out - rng.integers(0, 2, n), 0).astype(
            np.int64),
        n_quarantines=rng.integers(0, 3, n).astype(np.int64))
    period_est = np.where(rng.random(n) < 0.5, rng.uniform(0.02, 0.2, n),
                          np.nan)
    ref_period = rng.choice([0.02, 0.1], n)
    t_now = float(np.max(last_t) + rng.uniform(0.0, 3.0))
    return st, tracker, period_est, ref_period, t_now


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy,silent_after_s", [
    (dict(), None),
    (dict(recover_after_s=2.5), None),
    (dict(stale_factor=0.5, quarantine_factor=1.5, recover_after_s=1.0),
     4.0),
    (dict(quarantine_anomalous=False, quarantine_drifting=False), 10.0),
])
def test_health_step_matches_reference_bitwise(seed, policy, silent_after_s):
    st, tracker, period_est, ref_period, t_now = _random_health_case(seed)
    kw = dict(t_now=t_now, silent_after_s=silent_after_s, drift_tau_s=10.0,
              drift_rel=0.25, drift_abs_w=5.0)
    ref = RTracker(**{k: v.copy() for k, v in tracker.items()})
    port = HealthTracker(**{k: torch.tensor(v) for k, v in tracker.items()})
    for step in range(3):       # the machine carries state across steps
        want = ref.update(RState(**st), policy=RPolicy(**policy),
                          period_est=period_est, ref_period_s=ref_period,
                          **kw)
        got = port.update(
            DeviceState(**{k: torch.tensor(v) for k, v in st.items()}),
            policy=HealthPolicy(**policy),
            period_est=torch.tensor(period_est),
            ref_period_s=torch.tensor(ref_period), **kw)
        assert bool(got) == want, step
        for k in HEALTH_FIELDS:
            a, b = getattr(ref, k), _np(getattr(port, k))
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(b, a, err_msg=f"{step} {k}")
        assert port.counts() == ref.counts()
        kw["t_now"] += 1.7
        st["n_out"] = st["n_out"] + (np.arange(64) % 5 == step)


# ---------------------------------------------------------------------------
# the health machine, side by side (tests/test_resilience.py's cases)
# ---------------------------------------------------------------------------
def _health_pair(n=3, **pol):
    return _pair(n, silent_after_s=0.5, health=HealthPolicy(**pol))


def test_health_demotion_chain_silent_to_quarantined():
    ref, port = _health_pair()
    for mon in (ref, port):
        _steady(mon, [0, 1, 2], 0.0, 1.0)
        _steady(mon, [0], 1.0, 1.3)
    assert port.update_health(1.6) and ref.update_health(1.6)
    assert _np(port.health.code).tolist() == [0, STALE, STALE]
    assert_same_health(ref, port, "1.6")
    assert port.update_health(2.6) and ref.update_health(2.6)
    assert (_np(port.health.code)[1:] == QUARANTINED).all()
    assert port.counters["n_quarantined"] == 2
    assert port.health_summary()["coverage"] == pytest.approx(1.0 / 3.0)
    assert_same_health(ref, port, "2.6")


def test_health_recovery_needs_clean_dwell():
    ref, port = _health_pair(2, recover_after_s=1.0)
    for t_eval, span in ((3.0, (0.0, 1.0)), (3.4, (3.0, 3.3)),
                         (4.6, (3.3, 4.6))):
        for mon in (ref, port):
            _steady(mon, [0, 1], *span)
            mon.update_health(t_eval)
        assert_same_health(ref, port, str(t_eval))
    assert (_np(port.health.code) == 0).all()
    assert (_np(port.health.n_quarantines) == 1).all()


def test_health_instant_recovery_without_dwell():
    ref, port = _health_pair()
    for mon in (ref, port):
        _steady(mon, [0, 1, 2], 0.0, 1.0)
        mon.update_health(3.0)
    assert_same_health(ref, port, "down")
    for mon in (ref, port):
        _steady(mon, [0, 1, 2], 3.0, 3.5)
        mon.update_health(3.5)
    assert (_np(port.health.code) == 0).all()
    assert_same_health(ref, port, "up")


def test_health_update_bumps_epoch_only_on_change():
    ref, port = _health_pair()
    for mon in (ref, port):
        _steady(mon, [0, 1, 2], 0.0, 1.0)
    e = port.epoch
    assert not port.update_health(1.05) and not ref.update_health(1.05)
    assert port.epoch == e
    assert port.update_health(3.0) and ref.update_health(3.0)
    assert port.epoch == e + 1 == ref.epoch


def test_health_opt_in_default_changes_nothing():
    ref, port = _pair(3)
    _, tracked = _health_pair()
    for mon in (ref, port, tracked):
        _steady(mon, [0], 0.0, 1.0)
    assert port.health is None and port.health_policy is None
    assert "n_quarantined" not in port.counters
    assert port.counters == ref.counters
    s = port.health_summary()
    assert s == ref.health_summary()
    assert not s["tracked"] and s["coverage"] == 1.0
    fl = port.flags(t=5.0)
    assert not fl["stale"].any() and not fl["quarantined"].any()
    fe = port.fleet_energy()
    assert fe.coverage == 1.0 and fe.n_quarantined == 0
    # tracking health changes no accumulator
    plain = convert.monitor_arrays(port)
    with_health = convert.monitor_arrays(tracked)
    assert set(with_health) - set(plain) == {
        f"health.{k}" for k in HEALTH_FIELDS}
    assert_arrays_equal(plain, {k: v for k, v in with_health.items()
                                if not k.startswith("health.")})


def test_health_policy_validation_and_meta_roundtrip():
    for bad in (dict(stale_factor=0.0),
                dict(stale_factor=4.0, quarantine_factor=2.0),
                dict(recover_after_s=-1.0)):
        with pytest.raises(ValueError):
            HealthPolicy(**bad)
        with pytest.raises(ValueError):
            RPolicy(**bad)
    pol = HealthPolicy(stale_factor=1.5, recover_after_s=2.0)
    assert HealthPolicy.from_meta(pol.to_meta()) == pol
    rpol = RPolicy(stale_factor=1.5, recover_after_s=2.0)
    assert pol.to_meta() == rpol.to_meta()
    assert HealthPolicy.from_meta(rpol.to_meta()) == pol


# ---------------------------------------------------------------------------
# degraded-mode queries
# ---------------------------------------------------------------------------
def _fleet_fields(fe):
    return {k: v for k, v in dataclasses.asdict(fe).items()
            if v is not None}


def assert_fleet_match(fr, ft, label=""):
    assert_fingerprints_match(
        {f"fleet.{k}": v for k, v in _fleet_fields(fr).items()},
        {f"fleet.{k}": v for k, v in _fleet_fields(ft).items()}, label)
    assert ft.n_quarantined == fr.n_quarantined
    assert ft.coverage == fr.coverage


def test_quarantined_devices_excluded_with_widened_bounds():
    n = 4
    ref, port = _pair(n, seed=5, silent_after_s=0.5,
                      health=HealthPolicy())
    for mon in (ref, port):
        _steady(mon, range(n), 0.0, 2.01, p=100.0, dt=0.1)
    assert_fleet_match(ref.fleet_energy(), port.fleet_energy(), "base")
    for mon in (ref, port):
        _steady(mon, [0, 1, 2], 2.0, 4.0, p=100.0, dt=0.1)
        mon.update_health(4.0)       # device 3 silent 2.0 s > 3 × 0.5 s
    fr, ft = ref.fleet_energy(), port.fleet_energy()
    assert ft.n_quarantined == 1 and ft.coverage == 3 / 4
    assert float(ft.per_device_j[3]) > 0.0
    assert_fleet_match(fr, ft, "degraded")
    assert_fleet_match(ref.fleet_energy(3.9), port.fleet_energy(3.9), "t")


def test_all_quarantined_reports_inf_bounds():
    ref, port = _pair(2, silent_after_s=0.2, health=HealthPolicy())
    for mon in (ref, port):
        _steady(mon, [0, 1], 0.0, 0.5)
        mon.update_health(10.0)
    fe = port.fleet_energy()
    assert fe.coverage == 0.0 and fe.n_quarantined == 2
    assert fe.total_j == 0.0
    assert np.isinf(fe.sigma_independent_j)
    assert np.isinf(fe.sigma_worstcase_j)
    assert_fleet_match(ref.fleet_energy(), fe)


def test_by_label_reports_per_label_quarantine():
    ref, port = _both_monitors(6, silent_after_s=0.5, health=HealthPolicy())
    for mon in (ref, port):
        _steady(mon, range(6), 0.0, 1.01)
        _steady(mon, [0, 1, 2], 1.0, 3.0)
        mon.update_health(3.0)
    bl = port.by_label()
    assert sum(d["n_quarantined"] for d in bl.values()) == 3
    for t01 in ((None, None), (2.5, 2.9)):
        want = {f"{k}.{m}": np.float64(v)
                for k, d in ref.by_label(*t01).items() for m, v in d.items()}
        got = {f"{k}.{m}": np.float64(v)
               for k, d in port.by_label(*t01).items() for m, v in d.items()}
        assert_fingerprints_match(want, got, str(t01))


def test_query_service_applies_the_quarantine():
    ref, port = _both_monitors(6, silent_after_s=0.5, health=HealthPolicy())
    for mon in (ref, port):
        _steady(mon, range(6), 0.0, 1.01)
        _steady(mon, [0, 1, 2], 1.0, 3.0)
        mon.update_health(3.0)
    queries = lambda q: [q.fleet_energy(2.9), q.fleet_energy(None),  # noqa
                         q.by_label(), q.by_label(2.5, 2.9),
                         q.fleet_energy(2.95, corrected=False)]
    got_r = RService(ref).query_many(queries(RQuery))
    got_t = MonitorQueryService(port).query_many(queries(MonitorQuery))
    for i, (a, b) in enumerate(zip(got_r, got_t)):
        if isinstance(a, dict):
            assert_fingerprints_match(
                {f"{k}.{m}": np.float64(v) for k, d in a.items()
                 for m, v in d.items()},
                {f"{k}.{m}": np.float64(v) for k, d in b.items()
                 for m, v in d.items()}, f"q{i}")
        else:
            assert b.n_quarantined == 3
            assert_fleet_match(a, b, f"q{i}")
    # the batched answers equal the direct path's
    direct = port.fleet_energy(2.9)
    assert got_t[0].total_j == direct.total_j
    assert got_t[0].sigma_worstcase_j == direct.sigma_worstcase_j


def test_flags_surface_health_states():
    ref, port = _health_pair()
    for mon in (ref, port):
        _steady(mon, [0, 1, 2], 0.0, 1.0)
        _steady(mon, [0], 1.0, 1.3)
        mon.update_health(1.6)
    fl = port.flags(t=1.6)
    assert torch.equal(fl["stale"], port.health.code == STALE)
    assert torch.equal(fl["quarantined"], port.health.code == QUARANTINED)
    for k, v in ref.flags(t=1.6).items():
        np.testing.assert_array_equal(_np(fl[k]), v, err_msg=k)


def test_node_failure_fleet_bounded_error_and_honest_coverage():
    n = 8
    spec = FaultSpec(dropout_fraction=0.5, dropout_after=0.4, seed=3)
    inj = FaultInjector(spec, n, 0.0, 3.0, device=CPU)
    r_inj = RInjector(RSpec(**dataclasses.asdict(spec)), n, 0.0, 3.0)
    dead = np.isfinite(inj.log.dropout_t)
    assert 0 < dead.sum() < n
    ref, port = _pair(n, silent_after_s=0.2, health=HealthPolicy(),
                      health_every_s=0.1)
    powers = 100.0 + 10.0 * np.arange(n)
    ts_all = 0.05 * np.arange(81)
    for seq in range(8):
        sl = ts_all[(ts_all >= seq * 0.5) & (ts_all < (seq + 1) * 0.5)]
        dev = np.repeat(np.arange(n), sl.size).astype(np.int64)
        slab = (dev, np.tile(sl, n), powers[dev])
        port.ingest(*inj.apply(seq, *slab))
        ref.ingest(*r_inj.apply(seq, *slab))
        assert_same_health(ref, port, f"slab {seq}")
    for mon in (ref, port):
        mon.update_health(4.1)
    code = _np(port.health.code)
    assert (code[dead] == QUARANTINED).all() and (code[~dead] == 0).all()
    fe = port.fleet_energy()
    assert fe.n_quarantined == int(dead.sum())
    assert fe.total_j == pytest.approx(float(np.sum(powers[~dead]) * 3.95),
                                       rel=0.05)
    assert_fleet_match(ref.fleet_energy(), fe)
    assert_fingerprints_match(_fingerprint(ref), _fingerprint(port))


def test_grid_slabs_run_the_health_step_at_their_last_time():
    """``ingest_grid`` steps the machine at ``ts[-1]``, throttled by
    ``health_every_s``; a dirty slab falls back to ``ingest`` and steps
    there, as the reference does."""
    n, m = 5, 40
    ref, port = _pair(n, seed=2, silent_after_s=0.3,
                      health=HealthPolicy(recover_after_s=0.2),
                      health_every_s=0.25, envelope_w=(0.0, 200.0))
    rng = np.random.default_rng(4)
    t0 = 0.0
    for k in range(10):
        ts = t0 + 0.01 * np.arange(1, m + 1)
        rows = np.arange(n) if k < 3 or k > 6 else np.array([0, 2, 4])
        vals = rng.uniform(60.0, 180.0, (rows.size, m))
        if k == 5:
            vals[1, 3] = 500.0                # out of the envelope
        if k == 8:
            vals[0, 7] = np.nan               # dirty: the flat fallback
        for mon in (ref, port):
            mon.ingest_grid(rows, ts, vals)
        assert port.core._next_health_t == ref.core._next_health_t, k
        assert_same_health(ref, port, f"slab {k}")
        t0 = float(ts[-1])
    assert port.counters["n_quarantined"] + port.counters["n_stale"] > 0 \
        or int(port.health.n_quarantines.sum()) > 0
    assert_fingerprints_match(_fingerprint(ref), _fingerprint(port))


# ---------------------------------------------------------------------------
# grow (tests/test_collect.py's pins)
# ---------------------------------------------------------------------------
def _grow_slabs(n_before, n_after, seed):
    """Slabs over the first ``n_before`` devices, then over all
    ``n_after``."""
    early = _slabs(n_before, n_slabs=3, seed=seed)
    late = [s for s in _slabs(n_after, n_slabs=6, seed=seed + 1)[3:]]
    return early, late


@pytest.mark.parametrize("health", [False, True])
@pytest.mark.parametrize("grid", [False, True])
def test_grow_bitwise_equals_upfront_construction(health, grid):
    n0, n1 = 4, 7
    kw = dict(ring_slots=8, max_hold_s=2.0)
    if health:
        kw.update(health=HealthPolicy(), health_every_s=0.2,
                  silent_after_s=0.4)
    tail_labels = np.array(["new"] * (n1 - n0), dtype=object)
    labels = LABELS3[np.arange(n0) % 3]
    corr = _corr(n1, 3)
    full_corr = convert.stream_corrections(dataclasses.asdict(corr),
                                           device=CPU)
    head = StreamCorrections(**{
        f.name: getattr(full_corr, f.name)[:n0]
        for f in dataclasses.fields(StreamCorrections)})
    tail = StreamCorrections(**{
        f.name: getattr(full_corr, f.name)[n0:]
        for f in dataclasses.fields(StreamCorrections)})
    grown = MonitorService(n0, corrections=head, labels=labels,
                           device=CPU, **kw)
    grown.set_windows(0.5, 2.5)
    # the tail as grow leaves it: unlimited hold, windows disabled
    upfront = MonitorService(
        n1, corrections=full_corr, device=CPU,
        labels=np.concatenate([labels, tail_labels]),
        **dict(kw, max_hold_s=np.r_[np.full(n0, 2.0),
                                    np.full(n1 - n0, np.inf)]))
    upfront.set_windows(np.r_[np.full(n0, 0.5), np.full(n1 - n0, np.inf)],
                        np.r_[np.full(n0, 2.5), np.full(n1 - n0, -np.inf)])
    rg = RMonitor(n0, corrections=dataclasses.replace(
        corr, **{f.name: getattr(corr, f.name)[:n0]
                 for f in dataclasses.fields(corr)}), labels=labels,
        backend="numpy", **dict(kw, health=RPolicy() if health else None))
    rg.set_windows(0.5, 2.5)

    def feed(mon, dev, t, v):
        if not grid:
            return mon.ingest(dev, t, v)
        # rectangular slabs: every device of the slab at the same times
        devs = np.unique(dev)
        ts = np.unique(t)[:8]
        return mon.ingest_grid(devs, ts, np.add.outer(devs * 3.0, ts) + 90)

    early, late = _grow_slabs(n0, n1, seed=7)
    for s in early:
        for mon in (grown, upfront, rg):
            feed(mon, *s)
    e = grown.epoch
    snap = grown.snapshot()
    held = _np(snap.fleet_energy().per_device_j).copy()
    grown.grow(n1, corrections=tail, labels=tail_labels)
    rg.grow(n1, corrections=dataclasses.replace(
        corr, **{f.name: getattr(corr, f.name)[n0:]
                 for f in dataclasses.fields(corr)}), labels=tail_labels)
    assert grown.epoch == e + 1 and grown.n_devices == n1
    np.testing.assert_array_equal(_np(snap.fleet_energy().per_device_j),
                                  held)      # a held snapshot is unchanged
    for s in late:
        for mon in (grown, upfront, rg):
            feed(mon, *s)
    a, b = convert.monitor_arrays(grown), convert.monitor_arrays(upfront)
    assert_arrays_equal(a, b)
    assert grown.counters == upfront.counters
    assert list(grown.labels) == list(upfront.labels)
    for k in ("win_a", "win_b", "max_hold", "env_lo", "env_hi",
              "label_codes"):
        assert torch.equal(getattr(grown.core, f"_{k}"),
                           getattr(upfront.core, f"_{k}")), k
    # the epochs differ by grow's one bump
    assert grown.epoch == upfront.epoch + 1
    fg, fu = _fingerprint(grown), _fingerprint(upfront)
    fg.pop("health.epoch"), fu.pop("health.epoch")
    assert_fingerprints_equal(fg, fu)
    # and the reference grows to the same state
    assert rg.epoch == grown.epoch
    assert_fingerprints_match(_fingerprint(rg), _fingerprint(grown),
                              "vs reference")


def test_grow_validation():
    port = MonitorService(4, device=CPU)
    with pytest.raises(ValueError, match="shrink"):
        port.grow(2)
    with pytest.raises(ValueError, match="tail corrections"):
        port.grow(6, corrections=StreamCorrections.identity(3, device=CPU))
    with pytest.raises(ValueError, match="tail labels"):
        port.grow(6, labels=np.array(["a"], dtype=object))
    e = port.epoch
    port.grow(4)                              # no-op
    assert port.epoch == e and port.n_devices == 4
    ref = RMonitor(4, backend="numpy")
    for mon in (ref, port):
        with pytest.raises(ValueError):
            mon.grow(3)


def test_grow_epoch_bumps_and_serves_fresh():
    pairs = {}
    for name, mon, svc_cls, q_cls in (
            ("ref", RMonitor(2, backend="numpy"), RService, RQuery),
            ("port", MonitorService(2, device=CPU), MonitorQueryService,
             MonitorQuery)):
        mon.ingest(np.array([0, 1]), np.array([0.0, 0.0]),
                   np.array([100.0, 100.0]))
        mon.ingest(np.array([0, 1]), np.array([1.0, 1.0]),
                   np.array([100.0, 100.0]))
        svc = svc_cls(mon)
        q = q_cls.fleet_energy(t=1.0)
        before = svc.query(q)
        assert tuple(before.per_device_j.shape) == (2,)
        epoch0 = mon.epoch
        mon.grow(3)
        assert mon.epoch == epoch0 + 1
        mon.ingest(np.array([2, 2]), np.array([0.0, 1.0]),
                   np.array([50.0, 50.0]))
        after = svc.query(q)
        assert tuple(after.per_device_j.shape) == (3,)
        assert after.total_j == pytest.approx(before.total_j + 50.0)
        pairs[name] = after
    assert_fleet_match(pairs["ref"], pairs["port"])


# ---------------------------------------------------------------------------
# the crash-recovery supervisor
# ---------------------------------------------------------------------------
def _sup_factory(n, device=CPU):
    def factory():
        mon = MonitorService(
            n, corrections=convert.stream_corrections(
                dataclasses.asdict(_corr(n, 0)), device=device),
            labels=LABELS3[np.arange(n) % 3], max_hold_s=2.0, ring_slots=8,
            strict_ids=False, health=HealthPolicy(), health_every_s=0.25,
            silent_after_s=1.0, device=device)
        mon.set_windows(0.5, 2.5)
        return mon
    return factory


def _ref_sup_monitor(n):
    mon = RMonitor(n, corrections=_corr(n, 0),
                   labels=LABELS3[np.arange(n) % 3], max_hold_s=2.0,
                   ring_slots=8, strict_ids=False, health=RPolicy(),
                   health_every_s=0.25, silent_after_s=1.0,
                   backend="numpy")
    mon.set_windows(0.5, 2.5)
    return mon


def _port_faulty_source(spec, slabs, n, t0, t1, device=CPU):
    """``test_resilience._faulty_source`` through the port's injector: a
    fresh ``FaultInjector`` each call, so every (re)play emits the same
    faulted stream, as tensors on ``device``."""
    spec = FaultSpec(**dataclasses.asdict(spec))

    def source():
        inj = FaultInjector(spec, n, t0, t1, device=device)
        for seq, (dev, ts, vs) in enumerate(slabs):
            dev, ts, vs = inj.apply(seq, dev, ts, vs)
            if dev.numel():
                yield seq, dev, ts, vs
    return source


def _sources(spec, slabs, n, t0, t1):
    """The port's faulted source and the reference's, over the same
    input slabs."""
    return (_port_faulty_source(spec, slabs, n, t0, t1),
            _faulty_source(spec, slabs, n, t0, t1))


def _uninterrupted(sources, n):
    """Each package's monitor over its own injector's stream."""
    port_source, ref_source = sources
    port, ref = _sup_factory(n)(), _ref_sup_monitor(n)
    for _, dev, ts, vs in port_source():
        port.ingest(dev, ts, vs)
    for _, dev, ts, vs in ref_source():
        ref.ingest(dev, ts, vs)
    return port, ref


def test_both_injectors_emit_the_same_slabs():
    """The port's faulted source is bitwise the reference's: the same
    sequence numbers, ids, times (NaN where corrupt) and readings."""
    n, n_slabs = 6, 12
    port_source, ref_source = _sources(
        ALL_FAULTS, _slabs(n, n_slabs=n_slabs, seed=3), n, 0.0,
        0.5 * n_slabs)
    got, want = list(port_source()), list(ref_source())
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            assert _np(a).dtype == b.dtype
            np.testing.assert_array_equal(_np(a), b)


@pytest.mark.parametrize("asynchronous", [False, True])
@pytest.mark.parametrize("fail_at", [1, 4, 9])
def test_supervisor_recovery_is_bitwise(tmp_path, fail_at, asynchronous):
    n, n_slabs = 6, 12
    sources = _sources(ALL_FAULTS, _slabs(n, n_slabs=n_slabs, seed=3),
                       n, 0.0, 0.5 * n_slabs)
    source = sources[0]
    port, ref = _uninterrupted(sources, n)
    sup = MonitorSupervisor(_sup_factory(n), str(tmp_path / "ck"),
                            checkpoint_every=3, asynchronous=asynchronous,
                            device=CPU)
    report = sup.run(_crashing(source, fail_at))
    assert report.n_crashes == 1 and report.n_restores == 1
    assert report.n_slabs + report.n_skipped >= n_slabs
    got = _fingerprint(sup.monitor)
    assert_fingerprints_equal(got, _fingerprint(port))
    assert_arrays_equal(convert.monitor_arrays(sup.monitor),
                        convert.monitor_arrays(port))
    assert_fingerprints_match(_fingerprint(ref), got, "vs reference")


def test_supervisor_survives_repeated_crashes(tmp_path):
    n, n_slabs = 5, 10
    sources = _sources(ALL_FAULTS, _slabs(n, n_slabs=n_slabs, seed=6),
                       n, 0.0, 5.0)
    source = sources[0]
    port, _ = _uninterrupted(sources, n)
    sup = MonitorSupervisor(_sup_factory(n), str(tmp_path / "ck"),
                            checkpoint_every=2, device=CPU)
    report = sup.run(_crashing(source, 6, n_fails=3))
    assert report.n_crashes == 3 and report.n_restores == 3
    assert_fingerprints_equal(_fingerprint(sup.monitor), _fingerprint(port))


def test_supervisor_resumes_across_instances(tmp_path):
    n, n_slabs = 5, 10
    sources = _sources(ALL_FAULTS, _slabs(n, n_slabs=n_slabs, seed=4),
                       n, 0.0, 5.0)
    source = sources[0]
    port, _ = _uninterrupted(sources, n)

    def truncated():
        for i, slab in enumerate(source()):
            if i >= 6:
                return
            yield slab

    root = str(tmp_path / "ck")
    first = MonitorSupervisor(_sup_factory(n), root, checkpoint_every=4,
                              device=CPU)
    rep1 = first.run(truncated)
    assert rep1.n_slabs == 6 and rep1.resumed_from is None
    second = MonitorSupervisor(_sup_factory(n), root, checkpoint_every=4,
                               device=CPU)
    rep2 = second.run(source)
    assert rep2.resumed_from == rep1.last_seq
    assert rep2.n_skipped == 6
    assert_fingerprints_equal(_fingerprint(second.monitor),
                              _fingerprint(port))


def test_supervisor_exhausts_restores_and_reraises(tmp_path):
    def always_crash():
        raise RuntimeError("hopeless")
        yield  # pragma: no cover

    sup = MonitorSupervisor(lambda: MonitorService(2, device=CPU),
                            str(tmp_path / "ck"), max_restores=2,
                            device=CPU)
    with pytest.raises(RuntimeError, match="hopeless"):
        sup.run(always_crash)


def test_supervisor_validation():
    with pytest.raises(ValueError):
        MonitorSupervisor(lambda: None, "x", checkpoint_every=0)
    with pytest.raises(ValueError):
        MonitorSupervisor(lambda: None, "x", max_restores=-1)


# ---------------------------------------------------------------------------
# on the card: phase 9's gates at a small size (chip_smoke.py runs them at
# 100,000 devices)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _card_stream(n=48, m=50, n_slabs=12, seed=0):
    """Grid slabs with a seeded tenth of the devices silent from slab 4,
    half of those back from slab 9, and two devices out of the envelope
    from slab 4."""
    rng = np.random.default_rng(seed)
    silent = rng.choice(n, n // 10, replace=False)
    back = silent[: silent.size // 2]
    anom = rng.choice(np.setdiff1d(np.arange(n), silent), 2, replace=False)
    slabs = []
    for k in range(n_slabs):
        ts = 0.5 * k + 0.01 * np.arange(m)
        vals = rng.uniform(60.0, 300.0, (n, m))
        rows = np.arange(n)
        if k >= 4:
            vals[anom] = 5000.0
            gone = silent if k < 9 else np.setdiff1d(silent, back)
            rows = np.setdiff1d(rows, gone)
        slabs.append((rows, ts, vals[rows]))
    return slabs


def _card_monitor(n, device):
    return MonitorService(n, device=device, health=HealthPolicy(),
                          health_every_s=0.5, envelope_w=(0.0, 1000.0),
                          labels=LABELS3[np.arange(n) % 2])


def test_cuda_health_machine_matches_cpu(cuda):
    slabs = _card_stream()
    mons = [_card_monitor(48, d) for d in (cuda, CPU)]
    for dev, ts, vals in slabs:
        for mon in mons:
            mon.ingest_grid(dev, ts, vals)
        assert mons[0].counters == mons[1].counters
        for k in HEALTH_FIELDS:
            assert torch.equal(getattr(mons[0].health, k).cpu(),
                               getattr(mons[1].health, k)), k
    assert mons[0].counters["n_quarantined"] > 0


def test_cuda_checkpoint_resume_and_cpu_restore(cuda, tmp_path):
    from repro_torch.core.stream import restore_monitor, save_monitor
    slabs = _card_stream()
    live = _card_monitor(48, cuda)
    for s in slabs[:6]:
        live.ingest_grid(*s)
    save_monitor(live, str(tmp_path / "ck"))
    on_card = restore_monitor(str(tmp_path / "ck"), device=cuda)
    on_cpu = restore_monitor(str(tmp_path / "ck"), device=CPU)
    for s in slabs[6:]:
        for mon in (live, on_card, on_cpu):
            mon.ingest_grid(*s)
    assert_fingerprints_equal(_fingerprint(on_card), _fingerprint(live))
    assert on_cpu.counters == live.counters
    assert torch.equal(on_cpu.health.code, live.health.code.cpu())
    torch.testing.assert_close(on_cpu.state.energy_corr_j,
                               live.state.energy_corr_j.cpu(), rtol=RTOL,
                               atol=ATOL)


def test_cuda_supervisor_and_grow(cuda, tmp_path):
    slabs = _card_stream()
    ref = _card_monitor(48, cuda)
    for s in slabs:
        ref.ingest_grid(*s)

    def source():
        for seq, s in enumerate(slabs):
            yield (seq, *s)

    sup = MonitorSupervisor(lambda: _card_monitor(48, cuda),
                            str(tmp_path / "ck"), checkpoint_every=4,
                            device=cuda)
    report = sup.run(_crashing(source, 6), grid=True)
    assert report.n_crashes == report.n_restores == 1
    assert_fingerprints_equal(_fingerprint(sup.monitor), _fingerprint(ref))

    # grow: no envelope, which a grown tail would not share
    grown, upfront = (MonitorService(n, device=cuda, health=HealthPolicy(),
                                     health_every_s=0.5,
                                     labels=LABELS3[np.arange(n) % 2])
                      for n in (40, 48))
    for k, (dev, ts, vals) in enumerate(slabs):
        if k == 6:
            grown.grow(48, labels=LABELS3[np.arange(40, 48) % 2])
        keep = dev < 40 if k < 6 else np.ones(dev.size, bool)
        for mon in (grown, upfront):
            mon.ingest_grid(dev[keep], ts, vals[keep])
    fg, fu = _fingerprint(grown), _fingerprint(upfront)
    fg.pop("health.epoch"), fu.pop("health.epoch")
    assert_fingerprints_equal(fg, fu)
    # the label moments add on the card in no fixed order: not bitwise
    a, b = (convert.monitor_arrays(m) for m in (grown, upfront))
    assert_arrays_equal({k: v for k, v in a.items()
                         if not k.startswith("moments.")},
                        {k: v for k, v in b.items()
                         if not k.startswith("moments.")})
