"""The port's black-box characterisation (the paper's §4): Nelder–Mead,
the load helpers, ``microbench`` and the calibration records.

Three kinds of test:

* the port against the reference's numpy tier on the same inputs, with
  hidden parameters carried by ``repro_torch.convert.onboard_sensor`` and
  every draw substituted (reading noise, ADC noise, period jitter and the
  boxcar fit's repetition seeds; ``tests/_torch_draws.py``): bar 1e-12
  relative on everything not fitted by Nelder–Mead, 1e-9 relative on
  Nelder–Mead's outputs, transient kinds equal; the port's Nelder–Mead
  equals the reference's exactly;
* every case of the reference's ``tests/test_microbench.py`` rerun on the
  port with its own draws, at the reference's bars, the property tests
  over fixed seeded grids; ``tests/test_meter.py::
  test_calibration_removes_gain_bias`` and the calibration cases of
  ``tests/test_telemetry.py``, on the port;
* the numpy conventions the port keeps on tensors: ``np.median``'s mean
  of the two middle values, ``np.std``'s population form,
  ``np.linspace``'s grid and the least-squares fit.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_draws  # noqa: E402
from repro.core import load as rload  # noqa: E402
from repro.core import microbench as rmb  # noqa: E402
from repro.core import neldermead as rnm  # noqa: E402
from repro.core import profiles as rprofiles  # noqa: E402
from repro.core import sensor as rsensor  # noqa: E402
from repro.core.calibrate import CalibrationRecord as RCalib  # noqa: E402
from repro.core.calibrate import (  # noqa: E402
    record_from_characterisation as r_record_from_characterisation)
from repro.core.ground_truth import GroundTruthMeter as RMeter  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import load as loads  # noqa: E402
from repro_torch.core import meter as pm  # noqa: E402
from repro_torch.core import microbench as mb  # noqa: E402
from repro_torch.core import neldermead as nm  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.core.calibrate import (CalibrationRecord,  # noqa: E402
                                        CalibrationStore,
                                        record_from_characterisation)
from repro_torch.core.ground_truth import GroundTruthMeter  # noqa: E402
from repro_torch.core.sensor import (OnboardSensor, SensorProfile,  # noqa: E402
                                     SensorUnsupported)

CPU = "cpu"
RTOL = 1e-12      # everything not fitted by Nelder–Mead
RTOL_NM = 1e-9    # Nelder–Mead's outputs


def _sensor(name, seed):
    return OnboardSensor(profiles.get(name), seed=seed, device=CPU)


def _meter(seed, **kw):
    return GroundTruthMeter(seed=seed, device=CPU, **kw)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=0.0)


@pytest.fixture
def reference_draws(monkeypatch):
    _torch_draws.substitute_microbench(monkeypatch)


def _pair(profile, seed):
    """A reference sensor and the port's with its profile, seed and hidden
    parameters (``profile`` a catalog name or a reference profile)."""
    if isinstance(profile, str):
        profile = rprofiles.get(profile)
    ref = rsensor.OnboardSensor(profile, seed=seed)
    return ref, convert.onboard_sensor(ref, device=CPU)


# ---------------------------------------------------------------------------
# Nelder–Mead, the numpy conventions, the draws
# ---------------------------------------------------------------------------

NM_CASES = {
    "rosenbrock": lambda m: m.minimize(
        lambda v: (1 - v[0]) ** 2 + 100 * (v[1] - v[0] ** 2) ** 2,
        [-1.2, 1.0], max_iter=400),
    "bounded_2d": lambda m: m.minimize(
        lambda v: (v[0] - 3.0) ** 2 + (v[1] + 2.0) ** 2 + v[0] * v[1],
        [0.5, 0.0], bounds=[(0.0, 1.0), (-1.0, 1.0)], initial_step=[0.2, 0.3]),
    "scalar": lambda m: m.minimize_scalar(
        lambda w: (w - 0.37) ** 2 + 0.01 * np.sin(40.0 * w), 0.1, lo=0.0,
        hi=1.0),
}


@pytest.mark.parametrize("case", sorted(NM_CASES))
def test_neldermead_matches_reference(case):
    got, want = NM_CASES[case](nm), NM_CASES[case](rnm)
    np.testing.assert_array_equal(got.x, want.x)
    assert (got.fun, got.nit, got.nfev, got.converged) == (
        want.fun, want.nit, want.nfev, want.converged)


@pytest.mark.parametrize("n", [1, 2, 9, 10, 64])
def test_median_is_numpys(n):
    """``np.median`` averages the two middle values (``torch.median``
    returns the lower one)."""
    x = np.random.default_rng(n).standard_normal(n)
    assert float(mb._median(torch.as_tensor(x))) == np.median(x)
    x[n // 2] = np.nan
    assert np.isnan(float(mb._median(torch.as_tensor(x))))
    assert np.isnan(float(mb._median(torch.zeros(0, dtype=torch.float64))))


def test_normalise_is_numpys():
    v = np.random.default_rng(3).uniform(60.0, 250.0, 500)
    _close(mb._normalise(torch.as_tensor(v)), rmb._normalise(v))
    flat = np.full(7, 120.0)
    _close(mb._normalise(torch.as_tensor(flat)), rmb._normalise(flat))


def test_linspace_rows_are_numpys_bitwise():
    """The steady-state grid as ``np.linspace`` builds it, on every
    plateau window of the default schedule."""
    t0 = [i * 4.5 + 1.5 for i in range(56)]
    t1 = [i * 4.5 + 4.0 for i in range(56)]
    got = mb._linspace_rows(t0, t1, 64, CPU).numpy()
    want = np.stack([np.linspace(a, b, 64) for a, b in zip(t0, t1)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ts, vals", [
    (np.arange(12) * 0.01, np.array([1, 1, 2, 2, 2, 3, 3, 4, 4, 4, 4, 5.0])),
    (np.arange(5) * 0.1, np.array([1.0, 1.0, 2.0, 2.0, 2.0])),
    (np.arange(4) * 0.1, np.full(4, 3.0)),
])
def test_complete_run_durations_match_reference(ts, vals):
    got = mb.complete_run_durations(torch.as_tensor(ts), torch.as_tensor(vals))
    np.testing.assert_array_equal(got.numpy(),
                                  rmb.complete_run_durations(ts, vals))


def test_square_wave_with_reference_jitter_is_the_references(reference_draws):
    kw = dict(period_s=0.07, n_cycles=40, p_high=220.0, p_low=70.0,
              period_jitter_s=0.002, seed=12345)
    got, want = loads.square_wave(**kw), rload.square_wave(**kw)
    np.testing.assert_array_equal(got.edges.numpy(), want.edges)
    np.testing.assert_array_equal(got.powers.numpy(), want.powers)


def test_port_jitter_and_repetition_seeds_are_keyed():
    """The port's own draws: per cycle in [-j, j), per repetition in
    [0, 2^31), a function of the seed and the slot only."""
    j = loads._period_jitter(7, 50, 0.002)
    assert len(j) == 50 and all(-0.002 <= v < 0.002 for v in j)
    assert loads._period_jitter(7, 20, 0.002) == j[:20]
    assert loads._period_jitter(8, 20, 0.002) != j[:20]
    s = mb._repetition_seeds(11, 8)
    assert len(set(s)) == 8 and all(0 <= v < 2 ** 31 for v in s)
    assert mb._repetition_seeds(11, 3) == s[:3]
    flat = loads.square_wave(0.07, 5, 220.0, seed=3)
    np.testing.assert_array_equal(
        flat.edges.numpy(), rload.square_wave(0.07, 5, 220.0).edges)


@pytest.mark.parametrize("name", ["plateaus", "step"])
def test_load_helpers_match_reference(name):
    if name == "plateaus":
        lv = [loads.amplitude_for_fraction(f) for f in (0.0, 0.01, 0.5, 1.0)]
        assert lv == [rload.amplitude_for_fraction(f)
                      for f in (0.0, 0.01, 0.5, 1.0)]
        got, want = (loads.plateaus(lv, dwell_s=4.0, gap_s=0.5),
                     rload.plateaus(lv, dwell_s=4.0, gap_s=0.5))
    else:
        got, want = (loads.step(0.5, 6.0, 220.0, 70.0),
                     rload.step(0.5, 6.0, 220.0, 70.0))
    np.testing.assert_array_equal(got.edges.numpy(), want.edges)
    np.testing.assert_array_equal(got.powers.numpy(), want.powers)
    assert got.idle_w == want.idle_w


# ---------------------------------------------------------------------------
# the estimators against the reference, draws carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["a100", "v100", "turing",
                                     "rtx3090_instant"])
def test_update_period_matches_reference(reference_draws, profile):
    ref, port = _pair(profile, 7)
    _close(mb.estimate_update_period(port), rmb.estimate_update_period(ref))


@pytest.mark.parametrize("profile, T", [("a100", 0.100),
                                        ("rtx3090_average", 0.100),
                                        ("kepler", 0.015),
                                        ("maxwell", 0.100)])
def test_transient_matches_reference(reference_draws, profile, T):
    ref, port = _pair(profile, 3)
    got, want = mb.measure_transient(port, T), rmb.measure_transient(ref, T)
    assert got.kind == want.kind
    _close([got.rise_time_s, got.delay_s, got.settle_w],
           [want.rise_time_s, want.delay_s, want.settle_w])


@pytest.mark.parametrize("shape", ["linear", "logarithmic"])
def test_residual_fit_matches_reference(shape):
    """The classifier's two Nelder–Mead fits on the same ramp."""
    x = np.linspace(0.0, 1.0, 300)
    y = x.copy() if shape == "linear" else 1.0 - np.exp(-x / 0.3)
    y = y + np.random.default_rng(1).normal(0.0, 0.01, x.size)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    lin = ([(0.5, 1.5), (-0.5, 0.5)],
           lambda x_, p: float(p[0]) * x_ + float(p[1]),
           lambda x_, p: p[0] * x_ + p[1])
    log = ([(0.05, 2.0)],
           lambda x_, p: 1.0 - torch.exp(-x_ / max(float(p[0]), 1e-3)),
           lambda x_, p: 1.0 - np.exp(-x_ / np.maximum(p[0], 1e-3)))
    for bounds, port_model, ref_model in (lin, log):
        _close(mb._residual(xt, yt, port_model, bounds),
               rmb._residual(x, y, ref_model, bounds), RTOL_NM)


def test_steady_state_matches_reference(reference_draws):
    ref, port = _pair("rtx3090_instant", 3)
    got = mb.estimate_steady_state(port, _meter(4))
    want = rmb.estimate_steady_state(ref, RMeter(seed=4))
    _close([got.gain, got.offset_w, got.r2], [want.gain, want.offset_w,
                                              want.r2])
    _close(got.levels_sensor, want.levels_sensor)
    _close(got.levels_truth, want.levels_truth)


def test_steady_state_fit_is_least_squares():
    """The centred float64 fit against ``np.linalg.lstsq`` on the port's
    own plateau means."""
    ss = mb.estimate_steady_state(_sensor("rtx3090_instant", 21), _meter(22))
    x, y = ss.levels_truth.numpy(), ss.levels_sensor.numpy()
    (gain, offset), *_ = np.linalg.lstsq(np.stack([x, np.ones_like(x)], 1),
                                         y, rcond=None)
    _close([ss.gain, ss.offset_w], [gain, offset])
    pred = gain * x + offset
    r2 = 1.0 - np.sum((y - pred) ** 2) / np.sum((y - y.mean()) ** 2)
    _close(ss.r2, r2)


@pytest.mark.parametrize("profile", ["a100", "rtx3090_instant", "v100"])
def test_boxcar_window_matches_reference(reference_draws, profile):
    ref, port = _pair(profile, 5)
    T = rprofiles.get(profile).update_period_s
    est, samples = mb.estimate_boxcar_window(port, T, repetitions=8, seed=11)
    r_est, r_samples = rmb.estimate_boxcar_window(ref, T, repetitions=8,
                                                  seed=11)
    _close(est, r_est, RTOL_NM)
    _close(samples, r_samples, RTOL_NM)


@pytest.mark.parametrize("profile, with_meter", [
    ("a100", True), ("v100", False), ("rtx3090_average", False),
    ("kepler", False)])
def test_characterise_matches_reference(reference_draws, profile,
                                        with_meter):
    ref, port = _pair(profile, 9)
    got = mb.characterise(port, _meter(2) if with_meter else None,
                          boxcar_reps=6)
    want = rmb.characterise(ref, RMeter(seed=2) if with_meter else None,
                            boxcar_reps=6)
    assert got.transient.kind == want.transient.kind
    _close([got.update_period_s, got.transient.rise_time_s,
            got.transient.delay_s, got.transient.settle_w],
           [want.update_period_s, want.transient.rise_time_s,
            want.transient.delay_s, want.transient.settle_w])
    for f in ("gain", "offset_w", "r2", "window_s"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _close(a, b, RTOL_NM if f == "window_s" else RTOL)
    _close(got.sampled_fraction, want.sampled_fraction, RTOL_NM)
    got_rec = dataclasses.asdict(record_from_characterisation("d", profile,
                                                              got))
    want_rec = dataclasses.asdict(r_record_from_characterisation(
        "d", profile, want))
    assert got_rec.keys() == want_rec.keys()
    for k in sorted(set(got_rec) - {"created_at", "fitted_at"}):
        a, b = got_rec[k], want_rec[k]
        if isinstance(b, float):
            _close(a, b, RTOL_NM)
        else:
            assert a == b, k


# ---------------------------------------------------------------------------
# the cases of tests/test_microbench.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile,expect", [
    ("a100", 0.100), ("v100", 0.020), ("turing", 0.100),
    ("rtx3090_instant", 0.100),
])
def test_update_period_catalog(profile, expect):
    T = mb.estimate_update_period(_sensor(profile, 7))
    assert T == pytest.approx(expect, rel=0.15)


@pytest.mark.parametrize("seed", [0, 500])
@pytest.mark.parametrize("T", [0.015, 0.02, 0.05, 0.1, 0.2])
def test_update_period_property(T, seed):
    prof = SensorProfile("x", update_period_s=T, window_s=T / 4)
    est = mb.estimate_update_period(OnboardSensor(prof, seed=seed,
                                                  device=CPU))
    assert est == pytest.approx(T, rel=0.2)


class _StubSensor:
    """Duck-typed sensor with a hand-built reading series on tensors:
    readings change at given times, so the estimator's run-length policy
    can be pinned without seeding luck."""

    def __init__(self, change_times, duration_s):
        self.change_times = torch.as_tensor(change_times, dtype=torch.float64)
        self.duration_s = duration_s

    def attach(self, timeline, t_end=None):
        pass

    def poll(self, t0, t1, period_s=0.001):
        n = int(np.floor((t1 - t0) / period_s))
        ts = t0 + period_s * torch.arange(n, dtype=torch.float64)
        # reading value = number of change times passed (all distinct)
        vals = torch.searchsorted(self.change_times, ts, right=True)
        return ts, vals.to(torch.float64)


def test_update_period_uses_complete_runs_only():
    s = _StubSensor([0.03, 0.13, 0.33, 0.53], duration_s=0.60)
    est = mb.estimate_update_period(s, duration_s=0.60)
    assert est == pytest.approx(0.2, abs=1e-9)


def test_update_period_short_capture_returns_nan():
    s = _StubSensor([0.03, 0.13, 0.23], duration_s=0.30)
    assert np.isnan(mb.estimate_update_period(s, duration_s=0.30))


def test_update_period_accurate_on_short_capture():
    for seed in range(6):
        est = mb.estimate_update_period(_sensor("a100", seed),
                                        duration_s=0.75)
        assert est == pytest.approx(0.100, rel=0.05)


def test_transient_instant():
    tr = mb.measure_transient(_sensor("a100", 3), 0.100)
    assert tr.kind == "instant"
    assert tr.delay_s < 0.25


def test_transient_linear_1s():
    tr = mb.measure_transient(_sensor("rtx3090_average", 3), 0.100)
    assert tr.kind == "linear"
    assert 0.6 < tr.rise_time_s < 1.2


def test_transient_logarithmic():
    tr = mb.measure_transient(_sensor("kepler", 3), 0.015)
    assert tr.kind == "logarithmic"


def test_fermi_unsupported():
    with pytest.raises(SensorUnsupported):
        mb.estimate_update_period(_sensor("fermi1", 0))


@pytest.mark.parametrize("seed", [0, 1250, 2500, 3750, 5000, 6250, 7500,
                                  8750])
def test_steady_state_recovers_gain_offset(seed):
    s = _sensor("rtx3090_instant", seed)
    ss = mb.estimate_steady_state(s, _meter(seed + 1))
    assert ss.gain == pytest.approx(s.true_gain, abs=0.01)
    assert ss.offset_w == pytest.approx(s.true_offset, abs=2.5)
    assert ss.r2 > 0.999     # the paper's "near perfect linear" (Fig. 8)


def test_gain_error_is_proportional_not_flat():
    prof = SensorProfile("g", 0.1, 0.1, gain_tol=0.05, offset_tol_w=0.5,
                         noise_w=0.0)
    s = OnboardSensor(prof, seed=12, device=CPU)
    ss = mb.estimate_steady_state(s, _meter(3, noise_w=0.0))
    lo, hi = 100.0, 400.0
    err_lo = (ss.gain - 1) * lo + ss.offset_w
    err_hi = (ss.gain - 1) * hi + ss.offset_w
    assert abs(err_hi) > 2.0 * abs(err_lo)


@pytest.mark.parametrize("profile,W", [
    ("a100", 0.025), ("rtx3090_instant", 0.100), ("v100", 0.010)])
def test_boxcar_window_catalog(profile, W):
    prof = profiles.get(profile)
    est, samples = mb.estimate_boxcar_window(
        _sensor(profile, 5), prof.update_period_s, repetitions=8, seed=11)
    assert est == pytest.approx(W, rel=0.3)


@pytest.mark.parametrize("seed", [0, 100])
@pytest.mark.parametrize("frac", [0.25, 0.5, 1.0])
def test_boxcar_window_property(frac, seed):
    T = 0.1
    s = OnboardSensor(SensorProfile("x", T, T * frac), seed=seed, device=CPU)
    est, _ = mb.estimate_boxcar_window(s, T, repetitions=6, seed=seed)
    assert est == pytest.approx(T * frac, rel=0.35)


def test_characterise_a100_sampled_fraction():
    s = _sensor("a100", 9)
    res = mb.characterise(s, _meter(2), boxcar_reps=6)
    assert res.update_period_s == pytest.approx(0.100, rel=0.1)
    assert res.sampled_fraction == pytest.approx(0.25, rel=0.35)
    assert res.gain == pytest.approx(s.true_gain, abs=0.015)


def test_characterise_volta_half_time():
    res = mb.characterise(_sensor("v100", 9), boxcar_reps=6)
    assert res.sampled_fraction == pytest.approx(0.5, rel=0.35)


# ---------------------------------------------------------------------------
# tests/test_meter.py::test_calibration_removes_gain_bias, on the port
# ---------------------------------------------------------------------------

def _calib(name, gain=None, offset=None):
    """The reference test's record (tests/test_meter.py::_calib)."""
    p = profiles.get(name)
    W = p.window_s
    return CalibrationRecord(
        device_id="d0", profile_name=name,
        update_period_s=p.update_period_s, window_s=W,
        transient_kind="instant" if (W or 0) <= p.update_period_s
        else "linear",
        rise_time_s=0.25 if (W or 0) <= 0.1 else 1.25,
        gain=gain, offset_w=offset, sampled_fraction=p.sampled_fraction)


def test_calibration_removes_gain_bias():
    s = _sensor("rtx3090_instant", 77)
    ss = mb.estimate_steady_state(s, _meter(8))
    calib_plain = _calib("rtx3090_instant")
    calib_gain = _calib("rtx3090_instant", gain=ss.gain, offset=ss.offset_w)
    wl = pm.Workload("burst", loads.workload_burst(0.200, 230.0))
    est_plain = pm.measure_good_practice(s, wl, calib_plain,
                                         pm.GoodPracticeConfig(), seed=3)
    est_cal = pm.measure_good_practice(
        s, wl, calib_gain, pm.GoodPracticeConfig(apply_calibration=True),
        seed=3)
    truth = wl.true_energy_j
    assert abs(est_cal.error_vs(truth)) <= abs(est_plain.error_vs(truth)) + 0.01


# ---------------------------------------------------------------------------
# the calibration cases of tests/test_telemetry.py, on the port
# ---------------------------------------------------------------------------

def test_calibration_store_roundtrip(tmp_path):
    store = CalibrationStore(str(tmp_path))
    rec = CalibrationRecord("dev7", "a100", 0.1, 0.025, "instant", 0.25,
                            gain=0.96, offset_w=-1.2, r2=0.9999,
                            sampled_fraction=0.25)
    store.put(rec)
    got = CalibrationStore(str(tmp_path)).get("dev7")
    assert got is not None
    assert got.gain == pytest.approx(0.96)
    assert got.sampled_fraction == pytest.approx(0.25)
    assert got == rec


def test_from_json_tolerates_schema_drift():
    rec = CalibrationRecord("dev1", "a100", 0.1, 0.025, "instant", 0.25,
                            gain=0.97, sampled_fraction=0.25)
    d = json.loads(rec.to_json())
    d["retired_field"] = 123            # forward-compat: field was removed
    del d["sampled_fraction"]           # backward-compat: field was added
    del d["created_at"]
    got = CalibrationRecord.from_json(json.dumps(d))
    assert got.device_id == "dev1"
    assert got.gain == pytest.approx(0.97)
    assert got.sampled_fraction == 1.0  # dataclass default
    assert got.created_at == 0.0
    assert not hasattr(got, "retired_field")


def test_from_json_missing_required_field_raises():
    rec = CalibrationRecord("dev1", "a100", 0.1, 0.025, "instant", 0.25)
    d = json.loads(rec.to_json())
    del d["update_period_s"]            # required: no dataclass default
    with pytest.raises(ValueError, match="update_period_s"):
        CalibrationRecord.from_json(json.dumps(d))


def test_from_json_rejects_non_object():
    with pytest.raises(ValueError, match="JSON object"):
        CalibrationRecord.from_json("[1, 2, 3]")


def test_store_characterises_once(tmp_path):
    store = CalibrationStore(str(tmp_path))
    rec1 = store.get_or_characterise("devX", _sensor("v100", 4), _meter(5))
    assert rec1.update_period_s == pytest.approx(0.020, rel=0.2)
    # second call hits the cache (no sensor needed)
    rec2 = store.get_or_characterise("devX", None)
    assert rec2.created_at == rec1.created_at


def test_records_cross_between_the_packages():
    """The two packages write the same JSON: each loads the other's."""
    rec = CalibrationRecord("dev3", "v100", 0.02, 0.01, "instant", 0.05,
                            gain=1.01, offset_w=0.4, r2=0.99999,
                            sampled_fraction=0.5, created_at=12.5,
                            fitted_at=12.5, source="microbench.characterise")
    r_rec = RCalib.from_json(rec.to_json())
    assert dataclasses.asdict(r_rec) == dataclasses.asdict(rec)
    assert CalibrationRecord.from_json(r_rec.to_json()) == rec
