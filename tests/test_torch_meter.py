"""The port's scalar §5 path: timelines, ``GroundTruthMeter``,
``OnboardSensor`` and the scalar protocols (``measure_naive``,
``measure_good_practice``, ``compare_protocols``).

Three kinds of test:

* the cases of the reference's ``tests/test_timeline.py`` and
  ``tests/test_meter.py``, rerun on the port with its own draws (all but
  ``test_calibration_removes_gain_bias``, which needs the black-box
  characterisation and runs in ``tests/test_torch_microbench.py``); the
  property tests run over fixed seeded grids;
* the port against the reference's numpy tier on the same inputs, with
  hidden parameters carried by ``repro_torch.convert`` and the draws
  substituted (the reference's per-seed reading noise, start offsets and
  ADC noise): bar 1e-12 relative;
* the port's own contracts, at the reference's tolerances
  (``tests/test_fleet_engine.py``): a bank row and its
  ``scalar_reference`` read the same bitwise, the batched protocols
  match the scalar ones within 1e-9 J (naive) and 1e-3 J (§5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_draws  # noqa: E402
from repro.core import fleet_engine as rfe  # noqa: E402
from repro.core import load as rload  # noqa: E402
from repro.core import meter as rmeter  # noqa: E402
from repro.core import profiles as rprofiles  # noqa: E402
from repro.core import sensor as rsensor  # noqa: E402
from repro.core.calibrate import CalibrationRecord as RCalib  # noqa: E402
from repro.core.ground_truth import ActivityTimeline as RTimeline  # noqa: E402
from repro.core.ground_truth import GroundTruthMeter as RMeter  # noqa: E402
from repro.core.ground_truth import TimelineBank as RTBank  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fleet_engine as fe  # noqa: E402
from repro_torch.core import ground_truth as gt  # noqa: E402
from repro_torch.core import load as loads  # noqa: E402
from repro_torch.core import meter as pm  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.core.calibrate import CalibrationRecord  # noqa: E402
from repro_torch.core.sensor import OnboardSensor, _sum_timelines  # noqa: E402

CPU = "cpu"
RTOL = 1e-12
F64 = torch.float64


def _calib(name, gain=None, offset=None, cls=CalibrationRecord):
    """The reference test's record (tests/test_meter.py::_calib)."""
    p = profiles.get(name)
    W = p.window_s
    return cls(
        device_id="d0", profile_name=name,
        update_period_s=p.update_period_s, window_s=W,
        transient_kind="instant" if (W or 0) <= p.update_period_s
        else "linear",
        rise_time_s=0.25 if (W or 0) <= 0.1 else 1.25,
        gain=gain, offset_w=offset, sampled_fraction=p.sampled_fraction)


def _tl(tl):
    """A reference ActivityTimeline as the port's."""
    return convert.timeline(tl.edges, tl.powers, tl.idle_w)


def _sensor(name, seed):
    return OnboardSensor(profiles.get(name), seed=seed, device=CPU)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


BURST = pm.Workload("burst100ms", loads.workload_burst(0.100, 210.0))
R_BURST = rmeter.Workload("burst100ms", rload.workload_burst(0.100, 210.0))


@pytest.fixture
def reference_draws(monkeypatch):
    """The port draws the reference's numbers: a bank's reading noise is
    the reference's per-device ``default_rng(seed + row + 1)`` stream (a
    reference sensor of seed ``s`` is the port bank of seed ``s``, row 0),
    the §5 start offsets its ``default_rng(seed)`` uniforms, the meter's
    ADC noise its ``default_rng(seed)`` normals."""
    _torch_draws.substitute(monkeypatch, _torch_draws.reference_bank,
                            adc=True)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=0.0)


# ---------------------------------------------------------------------------
# the cases of tests/test_timeline.py, on the port
# ---------------------------------------------------------------------------

def test_power_at_basic():
    tl = gt.from_segments([(1.0, 100.0), (0.5, 50.0)], idle_w=60.0)
    assert float(tl.power_at(torch.tensor([0.5]))[0]) == 100.0
    assert float(tl.power_at(torch.tensor([1.2]))[0]) == 50.0
    assert float(tl.power_at(torch.tensor([2.0]))[0]) == 60.0
    assert float(tl.power_at(torch.tensor([-1.0]))[0]) == 60.0


def test_energy_analytic():
    tl = gt.from_segments([(1.0, 100.0), (0.5, 50.0)])
    assert tl.energy() == pytest.approx(125.0)
    assert float(tl.integral(0.5, 1.25)) == pytest.approx(0.5 * 100
                                                          + 0.25 * 50)


def test_mean_power():
    tl = gt.from_segments([(1.0, 100.0), (1.0, 50.0)])
    assert float(tl.mean_power(0.0, 2.0)) == pytest.approx(75.0)


def test_concat_and_repeat_preserve_energy():
    frag = gt.from_segments([(0.1, 200.0)], idle_w=60.0)
    train = frag.repeat(10)
    assert train.energy() == pytest.approx(10 * frag.energy())
    with_gaps = gt.ActivityTimeline.concat([frag] * 10, gap_s=0.05)
    assert with_gaps.energy() == pytest.approx(
        10 * frag.energy() + 9 * 0.05 * 60.0)
    assert with_gaps.t_end == pytest.approx(10 * 0.1 + 9 * 0.05)


def test_concat_is_contiguous():
    frag = gt.from_segments([(0.1, 200.0), (0.05, 80.0)])
    train = frag.repeat(4)
    for i in range(4):
        t = i * 0.15 + 1e-6
        assert float(train.power_at(torch.tensor([t]))[0]) == 200.0
        assert float(train.power_at(torch.tensor([t + 0.1]))[0]) == 80.0


def _random_segments(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 11))
    return ([(float(rng.uniform(0.01, 1.0)), float(rng.uniform(0.0, 500.0)))
             for _ in range(k)], float(rng.uniform(1.0, 100.0)))


@pytest.mark.parametrize("seed", range(6))
def test_integral_matches_riemann(seed):
    segs, idle = _random_segments(seed)
    tl = gt.from_segments(segs, idle_w=idle)
    t0, t1 = -0.5, tl.t_end + 0.5
    ts = torch.linspace(t0, t1, 20001, dtype=F64)
    dt = float(ts[1] - ts[0])
    riemann = float(tl.power_at(ts[:-1]).sum()) * dt
    exact = float(tl.integral(t0, t1))
    p_max = max(float(tl.powers.max()), idle)
    tol = dt * p_max * (len(tl.powers) + 2)
    assert exact == pytest.approx(riemann, rel=2e-3, abs=tol)


@pytest.mark.parametrize("period, n, hi, lo", [
    (0.02, 2, 100.0, 10.0), (0.3, 20, 400.0, 90.0), (0.137, 7, 255.5, 42.0),
    (0.05, 13, 180.0, 60.0), (0.21, 3, 333.0, 89.9)])
def test_square_wave_energy(period, n, hi, lo):
    tl = loads.square_wave(period, n, hi, lo, duty=0.5)
    assert tl.energy() == pytest.approx(n * period * 0.5 * (hi + lo),
                                        rel=1e-9)


def test_concat_gap_idle_energy_accounting():
    frag = gt.from_segments([(0.1, 200.0)], idle_w=60.0)
    over = gt.ActivityTimeline.concat([frag] * 4, gap_s=0.2, idle_w=10.0)
    assert over.energy() == pytest.approx(4 * 20.0 + 3 * 0.2 * 10.0)
    default = gt.ActivityTimeline.concat([frag] * 4, gap_s=0.2)
    assert default.energy() == pytest.approx(4 * 20.0 + 3 * 0.2 * 60.0)


def test_concat_mismatched_idle_w_uses_first_part():
    a = gt.from_segments([(0.1, 200.0)], idle_w=60.0)
    b = gt.from_segments([(0.1, 100.0)], idle_w=30.0)
    tl = gt.ActivityTimeline.concat([a, b], gap_s=0.5)
    assert tl.idle_w == 60.0
    assert float(tl.power_at(torch.tensor([0.3]))[0]) == 60.0
    assert tl.energy() == pytest.approx(20.0 + 10.0 + 0.5 * 60.0)


def test_concat_empty_parts_raises():
    with pytest.raises(ValueError, match="no parts"):
        gt.ActivityTimeline.concat([])


def test_zero_width_segments_contribute_nothing():
    tl = gt.from_segments([(0.5, 100.0), (0.0, 900.0), (0.5, 50.0)])
    assert tl.energy() == pytest.approx(75.0)
    assert float(tl.power_at(torch.tensor([0.5]))[0]) == 50.0
    train = tl.repeat(3)
    assert train.energy() == pytest.approx(3 * 75.0)
    assert train.t_end == pytest.approx(3.0)


def test_repeat_with_gap_matches_concat():
    frag = gt.from_segments([(0.1, 200.0), (0.05, 80.0)], idle_w=40.0)
    assert torch.equal(frag.repeat(5, gap_s=0.02).edges,
                       gt.ActivityTimeline.concat([frag] * 5,
                                                  gap_s=0.02).edges)


def test_sum_timelines_pointwise_and_idle():
    a = gt.from_segments([(1.0, 100.0), (1.0, 50.0)], idle_w=60.0)
    b = gt.from_segments([(0.5, 10.0), (2.0, 20.0)], t0=0.75, idle_w=40.0)
    s = _sum_timelines(a, b)
    assert s.idle_w == 100.0
    for ts in (torch.tensor([0.1, 0.8, 1.5, 2.2, 3.5], dtype=F64),
               torch.linspace(-0.5, 3.5, 4001, dtype=F64)):
        torch.testing.assert_close(s.power_at(ts),
                                   a.power_at(ts) + b.power_at(ts))


def test_sum_timelines_disjoint_support_gap_is_sum_of_idles():
    a = gt.from_segments([(1.0, 100.0)], idle_w=60.0)
    b = gt.from_segments([(1.0, 30.0)], t0=2.0, idle_w=40.0)
    s = _sum_timelines(a, b)
    assert float(s.power_at(torch.tensor([1.5]))[0]) == pytest.approx(100.0)
    assert s.energy() == pytest.approx(
        1.0 * (100.0 + 40.0) + 1.0 * (60.0 + 40.0) + 1.0 * (60.0 + 30.0))


def test_sum_timelines_with_zero_width_segments():
    a = gt.from_segments([(0.5, 100.0), (0.0, 999.0), (0.5, 50.0)],
                         idle_w=60.0)
    b = gt.from_segments([(1.0, 10.0)], idle_w=5.0)
    s = _sum_timelines(a, b)
    assert float(s.power_at(torch.tensor([0.25]))[0]) == pytest.approx(110.0)
    assert float(s.power_at(torch.tensor([0.75]))[0]) == pytest.approx(60.0)
    assert s.energy() == pytest.approx(0.5 * 110.0 + 0.5 * 60.0)


def test_pmd_trace_close_to_truth():
    tl = loads.square_wave(0.1, 20, 220.0, 70.0)
    meter = gt.GroundTruthMeter(seed=1, device=CPU)
    assert meter.energy(tl) == pytest.approx(tl.energy(), rel=0.02)


def test_meter_quantisation_error_is_bounded():
    tl = gt.from_segments([(2.0, 123.456)])
    meter = gt.GroundTruthMeter(noise_w=0.0, seed=0, device=CPU)
    ts, w = meter.trace(tl, 0.0, 2.0)
    assert bool(((w - 123.456).abs() < 0.6).all())


# ---------------------------------------------------------------------------
# the cases of tests/test_meter.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["a100", "rtx3090_instant",
                                     "rtx3090_average"])
def test_good_practice_beats_naive(profile):
    calib = _calib(profile)
    naive_errs, gp_errs = [], []
    for seed in range(5):
        r = pm.compare_protocols(_sensor(profile, 300 + seed), BURST, calib,
                                 pm.GoodPracticeConfig(), seed=seed)
        naive_errs.append(abs(r["naive_err"]))
        gp_errs.append(abs(r["gp_err"]))
    assert np.mean(gp_errs) < np.mean(naive_errs)
    assert np.mean(gp_errs) < 0.12
    assert np.mean(naive_errs) > 0.15


def test_error_reduction_magnitude_case3():
    calib = _calib("a100")
    reductions = []
    for seed in range(6):
        r = pm.compare_protocols(_sensor("a100", 400 + seed), BURST, calib,
                                 pm.GoodPracticeConfig(), seed=seed)
        reductions.append(abs(r["naive_err"]) - abs(r["gp_err"]))
    assert np.mean(reductions) > 0.10


def test_phase_shift_delays_reduce_error():
    calib = _calib("a100")
    wl = pm.Workload("structured100ms", loads.multi_phase_workload(
        [(0.050, 240.0), (0.050, 120.0)]))

    def errors(n_shifts):
        errs = []
        for seed in range(8):
            est = pm.measure_good_practice(
                _sensor("a100", 500 + seed), wl, calib,
                pm.GoodPracticeConfig(n_phase_shifts=n_shifts, n_trials=2),
                seed=seed)
            errs.append(est.error_vs(wl.true_energy_j))
        return np.asarray(errs)

    e0, e8 = errors(0), errors(8)
    assert np.abs(e8).mean() < np.abs(e0).mean()
    assert np.abs(e8).mean() < 0.10


def test_module_scope_guard():
    s = _sensor("gh200_module_instant", 1)
    with pytest.raises(pm.ModuleScopeError):
        pm.measure_naive(s, BURST)
    e = pm.measure_naive(_sensor("gh200_module_instant", 1), BURST,
                         host_baseline_w=0.0)
    assert np.isfinite(e)


@pytest.mark.parametrize("seed", [0, 17, 50])
@pytest.mark.parametrize("dur", [0.025, 0.1, 0.8])
def test_good_practice_error_bounded_across_durations(dur, seed):
    wl = pm.Workload("wl", loads.workload_burst(dur, 200.0))
    est = pm.measure_good_practice(_sensor("a100", seed), wl, _calib("a100"),
                                   pm.GoodPracticeConfig(), seed=seed)
    assert abs(est.error_vs(wl.true_energy_j)) < 0.15


def test_estimate_has_uncertainty_and_trials():
    est = pm.measure_good_practice(_sensor("a100", 2), BURST,
                                   _calib("a100"), pm.GoodPracticeConfig(),
                                   seed=0)
    assert est.n_trials == 4
    assert len(est.trial_values) == 4
    assert est.std_j >= 0.0


# ---------------------------------------------------------------------------
# against the reference's numpy tier, draws carried across
# ---------------------------------------------------------------------------

def test_timeline_queries_match_reference():
    rng = np.random.default_rng(3)
    rtl = rload.square_wave(0.137, 9, 231.0, 77.0).with_idle(55.0)
    ptl = _tl(rtl)
    tq = np.sort(rng.uniform(-0.5, rtl.t_end + 0.5, 400))
    _close(ptl.power_at(torch.as_tensor(tq)), rtl.power_at(tq), rtol=0)
    t0 = rng.uniform(-0.5, rtl.t_end, 300)
    t1 = t0 + rng.uniform(0.0, 1.0, 300)
    _close(ptl.integral(torch.as_tensor(t0), torch.as_tensor(t1)),
           rtl.integral(t0, t1))
    _close(ptl.mean_power(torch.as_tensor(t0), torch.as_tensor(t1)),
           rtl.mean_power(t0, t1))
    assert ptl.energy(0.3, 1.1) == pytest.approx(rtl.energy(0.3, 1.1),
                                                 rel=RTOL)
    assert ptl.with_idle(12.0).idle_w == rtl.with_idle(12.0).idle_w
    for got, want in ((ptl.repeat(4, gap_s=0.03), rtl.repeat(4, gap_s=0.03)),
                      (gt.ActivityTimeline.concat([ptl, ptl], 0.1, 5.0),
                       RTimeline.concat([rtl, rtl], 0.1, 5.0))):
        _close(got.edges, want.edges, rtol=0)
        _close(got.powers, want.powers, rtol=0)
        assert got.idle_w == want.idle_w

    rbank = RTBank.from_timelines([rtl, rload.workload_burst(0.3, 190.0),
                                   rload.square_wave(0.05, 3, 250.0, 60.0)])
    pbank = gt.TimelineBank(*(torch.as_tensor(x) for x in (
        rbank.edges, rbank.powers, rbank.idle_w, rbank.n_segs)))
    for i in range(3):
        row, want = pbank.row(i), rbank.row(i)
        _close(row.edges, want.edges, rtol=0)
        _close(row.powers, want.powers, rtol=0)
        assert row.idle_w == want.idle_w
    grid = rng.uniform(-0.5, 2.5, (3, 50))
    _close(pbank.power_at(torch.as_tensor(grid)), rbank.power_at(grid),
           rtol=0)
    _close(pbank.power_at(torch.as_tensor(grid[:1])),
           rbank.power_at(grid[:1]), rtol=0)
    a = rng.uniform(-0.5, 1.0, 3)
    b = a + rng.uniform(0.0, 2.0, 3)
    _close(pbank.mean_power(torch.as_tensor(a), torch.as_tensor(b)),
           rbank.mean_power(a, b))
    _close(pbank.energy(torch.as_tensor(a), torch.as_tensor(b)),
           rbank.energy(a, b))
    _close(pbank.energy(), rbank.energy())


def test_sum_timelines_matches_reference():
    a = rload.square_wave(0.2, 5, 210.0, 80.0)
    b = rload.workload_burst(0.7, 45.0, idle_w=30.0).shift(0.33)
    want = rsensor._sum_timelines(a, b)
    got = _sum_timelines(_tl(a), _tl(b))
    _close(got.edges, want.edges, rtol=0)
    _close(got.powers, want.powers, rtol=0)
    assert got.idle_w == want.idle_w


SCALAR_PROFILES = ["a100", "rtx3090_instant", "rtx3090_average", "v100",
                   "kepler", "fermi2", "h100_average"]


@pytest.mark.parametrize("profile", SCALAR_PROFILES)
def test_scalar_readings_match_reference(reference_draws, profile):
    """attach, query and poll, with the catalog's noise: bitwise, within
    1e-12 where the Kepler filter's exp enters."""
    rs = rsensor.OnboardSensor(rprofiles.get(profile), seed=41)
    ps = convert.onboard_sensor(rs, device=CPU)
    assert (ps.true_gain, ps.true_offset, ps.true_phase) == (
        rs.true_gain, rs.true_offset, rs.true_phase)
    tl = rload.square_wave(0.23, 12, 220.0, 90.0).shift(0.2)
    rs.attach(tl, t_end=4.0)
    ps.attach(_tl(tl), t_end=4.0)
    tq = np.linspace(-0.3, 4.2, 700)
    rtol = RTOL if profile == "kepler" else 0.0
    _close(ps.query(torch.as_tensor(tq)), rs.query(tq), rtol=rtol)
    ts, vals = ps.poll(0.0, 3.7, period_s=0.001)
    ts_r, vals_r = rs.poll(0.0, 3.7, period_s=0.001)
    _close(ts, ts_r, rtol=0)
    _close(vals, vals_r, rtol=rtol)


@pytest.mark.parametrize("profile", SCALAR_PROFILES)
def test_measure_naive_matches_reference(reference_draws, profile):
    wl = rmeter.Workload("w", rload.multi_phase_workload([(0.13, 215.0),
                                                          (0.07, 165.0)]))
    pwl = pm.Workload("w", _tl(wl.timeline))
    for seed in (7, 8):
        rs = rsensor.OnboardSensor(rprofiles.get(profile), seed=seed)
        ps = convert.onboard_sensor(rs, device=CPU)
        for off in (0.3, 0.337):
            want = rmeter.measure_naive(rs, wl, start_offset_s=off)
            got = pm.measure_naive(ps, pwl, start_offset_s=off)
            assert got == pytest.approx(want, rel=RTOL, abs=0.0)


@pytest.mark.parametrize("profile, cfg", [
    ("a100", {}), ("a100", {"n_phase_shifts": 0, "n_trials": 2}),
    ("rtx3090_instant", {"apply_calibration": True}),
    ("rtx3090_average", {"n_trials": 3}), ("v100", {"time_shift": False}),
    ("kepler", {"n_trials": 2}), ("fermi2", {"discard_rise": False})])
def test_measure_good_practice_matches_reference(reference_draws, profile,
                                                 cfg):
    rs = rsensor.OnboardSensor(rprofiles.get(profile), seed=12)
    ps = convert.onboard_sensor(rs, device=CPU)
    calib = _calib(profile, gain=1.02, offset=0.7)
    rcalib = _calib(profile, gain=1.02, offset=0.7, cls=RCalib)
    want = rmeter.measure_good_practice(rs, R_BURST, rcalib,
                                        rmeter.GoodPracticeConfig(**cfg),
                                        seed=5)
    got = pm.measure_good_practice(ps, BURST, calib,
                                   pm.GoodPracticeConfig(**cfg), seed=5)
    assert (got.n_trials, got.n_reps) == (want.n_trials, want.n_reps)
    _close(np.asarray(got.trial_values), np.asarray(want.trial_values))
    assert got.joules_per_rep == pytest.approx(want.joules_per_rep, rel=RTOL)
    assert got.std_j == pytest.approx(want.std_j, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("profile", ["a100", "rtx3090_average", "kepler"])
def test_compare_protocols_matches_reference(reference_draws, profile):
    for seed in (0, 3):
        rs = rsensor.OnboardSensor(rprofiles.get(profile), seed=300 + seed)
        ps = convert.onboard_sensor(rs, device=CPU)
        want = rmeter.compare_protocols(rs, R_BURST, _calib(profile,
                                                            cls=RCalib),
                                        rmeter.GoodPracticeConfig(n_trials=2),
                                        seed=seed)
        got = pm.compare_protocols(ps, BURST, _calib(profile),
                                   pm.GoodPracticeConfig(n_trials=2),
                                   seed=seed)
        assert set(got) == set(want)
        assert got["workload"] == want["workload"]
        for k in ("truth_j", "naive_j", "naive_err", "gp_j", "gp_err"):
            assert got[k] == pytest.approx(want[k], rel=RTOL, abs=1e-15), k
        assert got["gp_std_j"] == pytest.approx(want["gp_std_j"], rel=1e-9,
                                                abs=1e-12)


def test_module_scope_sensor_matches_reference(reference_draws):
    """A GH200 module-scope sensor with a host timeline, naive and §5 with
    a host baseline."""
    host = rload.workload_burst(3.0, 55.0, idle_w=40.0)
    rs = rsensor.OnboardSensor(rprofiles.get("gh200_module_instant"),
                               seed=9, host_timeline=host)
    ps = convert.onboard_sensor(rs, device=CPU)
    assert ps.host_timeline is not None
    want = rmeter.measure_naive(rs, R_BURST, host_baseline_w=40.0)
    got = pm.measure_naive(ps, BURST, host_baseline_w=40.0)
    assert got == pytest.approx(want, rel=RTOL)
    cfg = dict(n_trials=2)
    want = rmeter.measure_good_practice(
        rs, R_BURST, _calib("gh200_module_instant", cls=RCalib),
        rmeter.GoodPracticeConfig(**cfg), host_baseline_w=40.0, seed=2)
    got = pm.measure_good_practice(
        ps, BURST, _calib("gh200_module_instant"),
        pm.GoodPracticeConfig(**cfg), host_baseline_w=40.0, seed=2)
    assert got.joules_per_rep == pytest.approx(want.joules_per_rep, rel=RTOL)


def test_ground_truth_meter_matches_reference(reference_draws):
    tl = rload.square_wave(0.1, 20, 220.0, 70.0)
    for seed in (1, 2):
        rmeter_ = RMeter(seed=seed)
        pmeter = gt.GroundTruthMeter(seed=seed, device=CPU)
        ts_r, w_r = rmeter_.trace(tl)
        ts_p, w_p = pmeter.trace(_tl(tl))
        _close(ts_p, ts_r, rtol=0)
        _close(w_p, w_r, rtol=0)
        assert pmeter.energy(_tl(tl)) == pytest.approx(rmeter_.energy(tl),
                                                       rel=RTOL)
        assert pmeter.energy(_tl(tl), 0.4, 1.3) == pytest.approx(
            rmeter_.energy(tl, 0.4, 1.3), rel=RTOL)


def test_ground_truth_meter_energy_batch_matches_reference(reference_draws):
    tls = [rload.square_wave(0.1, 8, 220.0, 70.0),
           rload.workload_burst(0.35, 190.0),
           rload.multi_phase_workload([(0.13, 215.0), (0.07, 165.0)])]
    rbank = RTBank.from_timelines(tls)
    pbank = gt.TimelineBank(*(torch.as_tensor(x) for x in (
        rbank.edges, rbank.powers, rbank.idle_w, rbank.n_segs)))
    meter_r, meter_p = RMeter(seed=4), gt.GroundTruthMeter(seed=4,
                                                           device=CPU)
    _close(meter_p.energy_batch(pbank, chunk_rows=2),
           meter_r.energy_batch(rbank, chunk_rows=2))
    t0 = np.array([0.1, -0.2, 0.05])
    t1 = np.array([0.6, 0.3, 0.2])
    _close(meter_p.energy_batch(pbank, torch.as_tensor(t0),
                                torch.as_tensor(t1)),
           meter_r.energy_batch(rbank, t0, t1))


@pytest.mark.parametrize("timeline", ["shared", "per_device"])
def test_host_timeline_bank_matches_reference(reference_draws, timeline):
    """The reference's module-scope host-timeline pins
    (tests/test_fleet_engine.py, shared and per-device timelines) on the
    port's bank, hidden parameters and noise carried across."""
    host = rload.workload_burst(2.0, 55.0, idle_w=40.0)
    names = ["gh200_module_instant", "a100", "gh200_module_instant",
             "kepler"]
    rb = rfe.SensorBank.from_catalog(names, base_seed=9, host_timeline=host)
    pb = fe.SensorBank([profiles.get(n) for n in names], seed=9,
                       host_timeline=_tl(host), device=CPU)
    pb._set_hidden(*(torch.as_tensor(x) for x in (
        rb.true_gain, rb.true_offset, rb.true_phase, rb._model_gain)))
    if timeline == "shared":
        tl = rload.square_wave(0.230, 16, 220.0, 90.0)
        rb.attach(tl, t_end=4.0)
        pb.attach(_tl(tl), t_end=4.0)
    else:
        tls = [rload.square_wave(0.1 + 0.05 * i, 6, 200.0 + 10 * i, 80.0)
               for i in range(4)]
        rbank = RTBank.from_timelines(tls)
        rb.attach(rbank, t_end=4.0)
        pb.attach(gt.TimelineBank(*(torch.as_tensor(x) for x in (
            rbank.edges, rbank.powers, rbank.idle_w, rbank.n_segs))),
            t_end=4.0)
    qs = np.linspace(0.0, 4.0, 200)
    got, want = _np(pb.query(torch.as_tensor(qs))), rb.query(qs)
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL, atol=1e-9)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

TL = loads.square_wave(0.230, 16, 220.0, 90.0)
MIXED = ["a100", "h100_average", "v100", "rtx3090_530", "kepler",
         "maxwell", "fermi2", "gh200_gpu", "tpu_v5e_dash"]


def test_onboard_sensor_is_a_one_device_bank():
    for name in ("a100", "kepler", "fermi2"):
        s = _sensor(name, 23)
        bank = fe.SensorBank([profiles.get(name)], seed=23, device=CPU)
        assert s.true_gain == float(bank.true_gain[0])
        assert s.true_phase == float(bank.true_phase[0])
        s.attach(TL, t_end=5.0)
        bank.attach(TL, t_end=5.0)
        tq = torch.linspace(-0.2, 5.2, 333, dtype=F64)
        assert torch.equal(s.query(tq), bank.query(tq)[0])
        assert torch.equal(s.query(2.5), bank.query(2.5)[0])


@pytest.mark.parametrize("timeline", ["shared", "per_device"])
def test_scalar_reference_reads_bank_row_bitwise(timeline):
    bank = fe.SensorBank.from_catalog(MIXED, seed=42, device=CPU)
    if timeline == "shared":
        bank.attach(TL, t_end=6.0)
    else:
        tls = [loads.square_wave(0.1 + 0.03 * i, 5 + i, 200.0, 80.0)
               for i in range(len(MIXED))]
        tlb = gt.TimelineBank.from_timelines(tls, device=CPU)
        bank.attach(tlb, t_end=6.0)
    qs = torch.linspace(0.0, 6.0, 500, dtype=F64)
    got = bank.query(qs)
    ts_b, mat = bank.poll(0.0, 4.0, period_s=0.002, jitter_s=0.004)
    for i in range(len(MIXED)):
        s = bank.scalar_reference(i)
        assert s.profile is bank.profiles[i]
        s.attach(TL if timeline == "shared" else tls[i], t_end=6.0)
        assert torch.equal(s.query(qs), got[i]), MIXED[i]
        ts_s, v_s = s.poll(0.0, 4.0, period_s=0.002, jitter_s=0.004)
        assert torch.equal(ts_s, ts_b[i]) and torch.equal(v_s, mat[i])


def test_bank_poll_and_query_chunks():
    bank = fe.SensorBank.from_catalog(MIXED, seed=3, device=CPU)
    bank.attach(TL, t_end=4.0)
    ts, mat = bank.poll(0.0, 4.0, period_s=0.002)
    assert ts.shape == (2000,) and mat.shape == (len(MIXED), 2000)
    for chunk in (1, 4, "auto"):
        assert torch.equal(bank.query(ts, chunk_devices=chunk), mat)
    # jitter: sorted, late by less than jitter_s, per-device
    tj, mj = bank.poll(0.0, 4.0, period_s=0.002, jitter_s=0.003,
                       chunk_devices=2)
    assert tj.shape == mat.shape
    assert bool((torch.diff(tj, dim=1) >= 0).all())
    assert bool(((tj - ts) >= 0).all() and ((tj - ts) < 0.003 + 0.002).all())
    assert not torch.equal(tj[0], tj[1])


@pytest.mark.parametrize("t0, t1, period", [(0.0, 0.3, 0.1), (0.1, 0.7, 0.1),
                                            (0.0, 2.9, 0.001)])
def test_poll_count_is_the_references(t0, t1, period):
    """``floor((t1 - t0) / period)`` on the host, as the reference: an
    off-by-one sample would change the integral."""
    rs = rsensor.OnboardSensor(rprofiles.get("a100"), seed=1)
    rs.attach(rload.workload_burst(0.5, 200.0), t_end=4.0)
    ps = convert.onboard_sensor(rs, device=CPU)
    ps.attach(_tl(rload.workload_burst(0.5, 200.0)), t_end=4.0)
    ts_r, _ = rs.poll(t0, t1, period)
    ts_p, _ = ps.poll(t0, t1, period)
    _close(ts_p, ts_r, rtol=0)


def test_measure_naive_batch_matches_scalar():
    wl = pm.Workload("w", loads.multi_phase_workload([(0.130, 215.0),
                                                      (0.070, 165.0)]))
    names = ["a100", "a100", "rtx3090_average", "v100", "kepler"]
    bank = fe.SensorBank.from_catalog(names, seed=7, device=CPU)
    batch = pm.measure_naive_batch(bank, wl)
    for i in range(len(names)):
        ref = pm.measure_naive(bank.scalar_reference(i), wl)
        assert float(batch[i]) == pytest.approx(ref, abs=1e-9)


def test_measure_naive_batch_per_device_workloads_matches_scalar():
    names = ["a100", "v100", "kepler", "rtx3090_average"]
    rng = np.random.default_rng(2)
    wls = [pm.Workload(f"w{i}", loads.multi_phase_workload(
        [(float(rng.uniform(0.05, 0.2)), float(rng.uniform(180, 240))),
         (float(rng.uniform(0.03, 0.1)), float(rng.uniform(120, 180)))]))
        for i in range(len(names))]
    bank = fe.SensorBank.from_catalog(names, seed=7, device=CPU)
    batch = pm.measure_naive_batch(bank, pm.WorkloadSet(wls, device=CPU))
    for i in range(len(names)):
        ref = pm.measure_naive(bank.scalar_reference(i), wls[i])
        assert float(batch[i]) == pytest.approx(ref, abs=1e-9)


def test_measure_good_practice_batch_matches_scalar():
    wl = pm.Workload("w", loads.multi_phase_workload([(0.130, 215.0),
                                                      (0.070, 165.0)]))
    names = ["a100", "a100", "rtx3090_average", "v100", "kepler"]
    bank = fe.SensorBank.from_catalog(names, seed=7, device=CPU)
    cfg = pm.GoodPracticeConfig(n_trials=2)
    calibs = {n: profiles_calib(n) for n in set(names)}
    batch = pm.measure_good_practice_batch(bank, wl, calibs, cfg)
    for i, name in enumerate(names):
        ref = pm.measure_good_practice(bank.scalar_reference(i), wl,
                                       calibs[name], cfg, seed=i)
        view = batch.device(i)
        assert view.joules_per_rep == pytest.approx(ref.joules_per_rep,
                                                    abs=1e-3)
        np.testing.assert_allclose(view.trial_values, ref.trial_values,
                                   atol=1e-3)
        assert view.n_reps == ref.n_reps and view.n_trials == ref.n_trials


def profiles_calib(name):
    """The reference fleet test's record: rise 2.5 update periods."""
    p = profiles.get(name)
    return CalibrationRecord("d", name, p.update_period_s, p.window_s,
                             "instant", 2.5 * p.update_period_s,
                             sampled_fraction=p.sampled_fraction)


def test_energy_batch_rows_are_scalar_meters():
    tls = [loads.square_wave(0.1, 8, 220.0, 70.0),
           loads.workload_burst(0.35, 190.0),
           loads.multi_phase_workload([(0.13, 215.0), (0.07, 165.0)])]
    bank = gt.TimelineBank.from_timelines(tls, device=CPU)
    meter = gt.GroundTruthMeter(seed=11, device=CPU)
    batch = meter.energy_batch(bank, chunk_rows=1)
    assert torch.equal(batch, meter.energy_batch(bank))
    for i in range(3):
        one = gt.GroundTruthMeter(seed=11 + i, device=CPU).energy(bank.row(i))
        assert float(batch[i]) == pytest.approx(one, rel=RTOL)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        OnboardSensor(profiles.get("a100"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.GroundTruthMeter().trace(TL)
