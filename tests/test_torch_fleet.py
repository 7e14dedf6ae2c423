"""The port's sensor source and timelines against the JAX package's, and a
small end-to-end replay of both packages on the same fleet.

The hidden gain, offset and phase come across from the reference bank
through ``repro_torch.convert``; profiles are taken with ``noise_w=0`` so
that the readings are deterministic in both (the port's noise is its own
seeded stream, checked statistically).  Readings, ticks and schedules
are then bitwise equal; energies agree to rtol = atol = 1e-12.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import load as loads  # noqa: E402
from repro.core import profiles as rprofiles  # noqa: E402
from repro.core.fleet_engine import SensorBank as RBank  # noqa: E402
from repro.core.fleet_engine import StreamingMoments as RMoments  # noqa: E402
from repro.core.ground_truth import TimelineBank as RTimelineBank  # noqa: E402
from repro.core.stream import MonitorService as RMonitor  # noqa: E402
from repro.core.stream import replay as rreplay  # noqa: E402
from repro.core.stream.estimators import (  # noqa: E402
    StreamCorrections as RCorrections,
    default_calibrations as r_default_calibrations)
from repro_torch import convert  # noqa: E402
from repro_torch.core import ground_truth as gt  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.core.fleet_engine import (SensorBank,  # noqa: E402
                                           StreamingMoments)
from repro_torch.core.stream import (MonitorService,  # noqa: E402
                                     StreamCorrections, default_calibrations,
                                     replay)

CPU = "cpu"
RTOL = ATOL = 1e-12
NAMES = ["a100"] * 4 + ["h100_instant"] * 3 + ["v100"] * 2


def _timeline():
    return loads.multi_phase_workload([(0.13, 215.0), (0.07, 165.0),
                                       (0.31, 240.0), (0.05, 90.0)])


def _port_timeline(tl):
    return gt.ActivityTimeline(torch.as_tensor(tl.edges),
                               torch.as_tensor(tl.powers), tl.idle_w)


def _banks(names=NAMES, noise=0.0, shifts=None, **attach):
    """A reference bank and the port's, same hidden parameters, attached
    to the same timeline."""
    rprof = [dataclasses.replace(rprofiles.get(n), noise_w=noise)
             for n in names]
    rb = RBank(rprof, seeds=np.arange(len(names)) + 11)
    tl = _timeline().shift(0.3)
    rb.attach(tl, shifts=shifts, **attach)
    tb = SensorBank([dataclasses.replace(profiles.get(n), noise_w=noise)
                     for n in names], device=CPU)
    tb._set_hidden(*(torch.as_tensor(x) for x in
                     (rb.true_gain, rb.true_offset, rb.true_phase)))
    tb.attach(_port_timeline(tl),
              shifts=None if shifts is None else torch.as_tensor(shifts),
              **attach)
    return rb, tb, tl


@pytest.mark.parametrize("shifted", [False, True])
def test_attach_schedule_is_bitwise_the_reference(shifted):
    shifts = (np.random.default_rng(0).uniform(0.0, 0.4, len(NAMES))
              if shifted else None)
    rb, tb, _ = _banks(shifts=shifts)
    np.testing.assert_array_equal(tb._ticks.numpy(), rb._ticks)
    np.testing.assert_array_equal(tb._values.numpy(), rb._values)
    np.testing.assert_array_equal(tb._first.numpy(), rb._first)
    np.testing.assert_array_equal(tb._last.numpy(), rb._last)
    tq = np.linspace(-0.5, 2.0, 301)
    np.testing.assert_array_equal(tb.query(torch.as_tensor(tq)).numpy(),
                                  rb.query(tq))
    np.testing.assert_array_equal(tb.query(0.77).numpy(), rb.query(0.77))


def test_attach_per_device_timeline_bank_is_bitwise_the_reference():
    rb, tb, tl = _banks()
    shifts = np.random.default_rng(5).uniform(0.0, 0.4, len(NAMES))
    rb.attach(RTimelineBank.from_timeline(tl, len(NAMES), shifts))
    tb.attach(gt.TimelineBank.from_timeline(
        _port_timeline(tl), len(NAMES), torch.as_tensor(shifts), device=CPU))
    np.testing.assert_array_equal(tb._ticks.numpy(), rb._ticks)
    np.testing.assert_array_equal(tb._values.numpy(), rb._values)
    with pytest.raises(ValueError, match="redundant"):
        tb.attach(gt.TimelineBank.from_timeline(
            _port_timeline(tl), len(NAMES), device=CPU),
            shifts=torch.zeros(len(NAMES), dtype=torch.float64))


def test_convert_sensor_bank_carries_hidden_parameters():
    rb, _, tl = _banks()
    cb = convert.sensor_bank(NAMES, rb.true_gain, rb.true_offset,
                             rb.true_phase, device=CPU)
    np.testing.assert_array_equal(cb.true_gain.numpy(), rb.true_gain)
    np.testing.assert_array_equal(cb.true_phase.numpy(), rb.true_phase)


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("chunk", [None, 4])
def test_iter_poll_slabs_is_bitwise_the_reference(grid, chunk):
    rb, tb, _ = _banks()
    got = list(tb.iter_poll_slabs(0.0, 1.2, period_s=0.001, tick_s=0.25,
                                  chunk_devices=chunk, device_base=3,
                                  grid=grid))
    ref = list(rb.iter_poll_slabs(0.0, 1.2, period_s=0.001, tick_s=0.25,
                                  chunk_devices=chunk, device_base=3,
                                  grid=grid))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a.numpy(), b)


def test_round_half_to_even_like_the_reference():
    """np.round and torch.round both round half to even: readings that
    land on exact .5 quanta must round the same way in both packages."""
    prof = dataclasses.replace(profiles.get("a100"), quantum_w=1.0,
                               noise_w=0.0)
    rprof = dataclasses.replace(rprofiles.get("a100"), quantum_w=1.0,
                                noise_w=0.0)
    n = 6
    rb = RBank([rprof] * n, seeds=np.arange(n))
    tb = SensorBank([prof] * n, device=CPU)
    gain = np.ones(n)
    offset = np.array([0.5, 1.5, 2.5, -0.5, 0.25, 3.5])
    phase = np.full(n, 0.05)
    rb._gain, rb._offset, rb._phase = gain, offset, phase
    tb._set_hidden(torch.as_tensor(gain), torch.as_tensor(offset),
                   torch.as_tensor(phase))
    flat = loads.multi_phase_workload([(2.0, 100.0)])
    rb.attach(flat)
    tb.attach(_port_timeline(flat))
    np.testing.assert_array_equal(tb._values.numpy(), rb._values)
    # exact halves: to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2), in both
    halves = np.arange(-5, 6) + 0.5
    np.testing.assert_array_equal(torch.round(torch.as_tensor(halves))
                                  .numpy(), np.round(halves))
    assert np.round(2.5) == 2.0 and float(torch.round(
        torch.tensor(2.5, dtype=torch.float64))) == 2.0


def test_port_noise_and_hidden_parameters_are_seeded_and_in_tolerance():
    names = ["a100"] * 4000
    b1 = SensorBank.from_catalog(names, seed=5, device=CPU)
    b2 = SensorBank.from_catalog(names, seed=5, device=CPU)
    b3 = SensorBank.from_catalog(names, seed=6, device=CPU)
    assert torch.equal(b1.true_gain, b2.true_gain)
    assert not torch.equal(b1.true_gain, b3.true_gain)
    p = profiles.get("a100")
    for x, lo, hi in ((b1.true_gain, 1 - p.gain_tol, 1 + p.gain_tol),
                      (b1.true_offset, -p.offset_tol_w, p.offset_tol_w),
                      (b1.true_phase, 0.0, p.update_period_s)):
        assert float(x.min()) >= lo and float(x.max()) <= hi
        # uniform on [lo, hi]: mean within 5 standard errors of the middle
        se = (hi - lo) / np.sqrt(12 * len(names))
        assert abs(float(x.mean()) - 0.5 * (lo + hi)) < 5 * se
    flat = gt.from_segments([(3.0, 200.0)])
    b1.attach(flat)
    b2.attach(flat)
    assert torch.equal(b1._values, b2._values)
    # readings minus the noise-free schedule: N(0, noise_w) up to the
    # reporting quantum
    q = SensorBank.from_catalog(names, seed=5, device=CPU)
    q.noise_w = torch.zeros_like(q.noise_w)
    q.attach(flat)
    valid = q._values > 0
    resid = (b1._values - q._values)[valid]
    assert abs(float(resid.mean())) < 5 * p.noise_w / np.sqrt(resid.numel())
    assert abs(float(resid.std()) - np.hypot(p.noise_w, p.quantum_w
                                             / np.sqrt(12))) < 0.01


def test_non_boxcar_profiles_name_the_later_slice():
    """The logarithmic and estimation transients came with the fleet-audit
    slice; the module-scope host timeline came with the scalar §5 slice:
    it adds the host's draw to the module-scope rows only, and per-device
    shifts with it still raise, as in the reference."""
    for name in ("kepler", "fermi2"):
        bank = SensorBank.from_catalog([name], device=CPU)
        bank.attach(_port_timeline(_timeline()))
        assert bool(torch.isfinite(bank._values).all())
    names = ["gh200_module_instant", "a100"]
    host = gt.from_segments([(4.0, 55.0)], idle_w=40.0)
    plain = SensorBank.from_catalog(names, seed=3, device=CPU)
    with_host = SensorBank.from_catalog(names, seed=3, device=CPU,
                                        host_timeline=host)
    for b in (plain, with_host):
        b.attach(_port_timeline(_timeline()), t_end=2.0)
    tq = torch.linspace(0.5, 1.5, 11, dtype=torch.float64)
    d = with_host.query(tq) - plain.query(tq)
    assert torch.equal(d[1], torch.zeros(11, dtype=torch.float64))
    assert float((d[0] / with_host.true_gain[0] - 55.0).abs().max()) < 0.05
    with pytest.raises(NotImplementedError, match="module-scope host"):
        with_host.attach(_port_timeline(_timeline()),
                         shifts=torch.zeros(2, dtype=torch.float64))


def test_timeline_bank_integral_matches_reference():
    tl = _timeline()
    shifts = np.random.default_rng(2).uniform(0.0, 0.5, 7)
    rbank = RTimelineBank.from_timeline(tl, 7, shifts)
    tbank = gt.TimelineBank.from_timeline(_port_timeline(tl), 7,
                                          torch.as_tensor(shifts),
                                          device=CPU)
    np.testing.assert_array_equal(tbank.edges.numpy(), rbank.edges)
    a = np.random.default_rng(3).uniform(-0.5, 1.0, 7)
    for t0, t1 in ((a, a + 0.4), (0.1, 0.9), (a[:, None],
                                              a[:, None] + [[0.1, 0.2]])):
        t0t = torch.as_tensor(np.asarray(t0))
        t1t = torch.as_tensor(np.asarray(t1))
        np.testing.assert_allclose(tbank.integral(t0t, t1t).numpy(),
                                   rbank.integral(t0, t1), rtol=RTOL,
                                   atol=ATOL)
    both = gt.TimelineBank.from_timelines(
        [_port_timeline(tl), gt.from_segments([(0.2, 150.0)])], device=CPU)
    rboth = RTimelineBank.from_timelines(
        [tl, loads.multi_phase_workload([(0.2, 150.0)])])
    np.testing.assert_array_equal(both.edges.numpy(), rboth.edges)
    np.testing.assert_array_equal(both.shift([0.1, 0.2]).rows([1]).edges
                                  .numpy(), rboth.shift([0.1, 0.2]).rows(
                                      [1]).edges)


def test_streaming_moments_merge_like_the_reference():
    rng = np.random.default_rng(4)
    ref, port = RMoments(), StreamingMoments()
    for k in (5, 0, 17, 3):
        e = rng.normal(2.0, 3.0, k)
        ref.update(e)
        port.update(torch.as_tensor(e))
    for key, val in ref.stats().items():
        np.testing.assert_allclose(port.stats()[key], val, rtol=RTOL,
                                   atol=ATOL)


def test_corrections_from_calibrations_match_reference():
    rc = RCorrections.from_calibrations(NAMES, r_default_calibrations(NAMES),
                                        baseline_w=2.0)
    tc = StreamCorrections.from_calibrations(
        NAMES, default_calibrations(NAMES), baseline_w=2.0, device=CPU)
    for k, a in dataclasses.asdict(rc).items():
        np.testing.assert_array_equal(getattr(tc, k).numpy(), a)
    ident = StreamCorrections.identity(3, device=CPU)
    assert bool((ident.gain == 1).all()) and not bool(ident.calibrated.any())


@pytest.mark.parametrize("grid", [False, True])
def test_end_to_end_replay_matches_reference(grid):
    """Both packages replay the same fleet (hidden parameters carried
    across, noise-free readings) through their monitors: window energies,
    counters and per-label statistics agree."""
    shifts = np.random.default_rng(1).uniform(0.0, 0.3, len(NAMES))
    rb, tb, tl = _banks(shifts=shifts)
    labels = np.array(NAMES, dtype=object)
    rc = RCorrections.from_calibrations(NAMES, r_default_calibrations(NAMES))
    ref = RMonitor(len(NAMES), backend="numpy", corrections=rc,
                   labels=labels)
    port = MonitorService(len(NAMES), device=CPU, labels=labels,
                          corrections=StreamCorrections.from_calibrations(
                              NAMES, default_calibrations(NAMES),
                              device=CPU))
    a = tl.t_start + shifts
    b = tl.t_end + shifts
    ref.set_windows(a, b)
    port.set_windows(torch.as_tensor(a), torch.as_tensor(b))
    rreplay(rb, ref, 0.0, 1.6, grid=grid)
    replay(tb, port, 0.0, 1.6, grid=grid)
    assert ref.counters == port.counters
    for corrected in (False, True):
        np.testing.assert_allclose(
            port.window_energy(corrected=corrected).numpy(),
            ref.window_energy(corrected=corrected), rtol=RTOL, atol=ATOL)
        fe_r = ref.fleet_energy(corrected=corrected)
        fe_t = port.fleet_energy(corrected=corrected)
        np.testing.assert_allclose(fe_t.total_j, fe_r.total_j, rtol=RTOL)
    for lbl, stats in ref.by_label().items():
        for key, val in stats.items():
            np.testing.assert_allclose(port.by_label()[lbl][key], val,
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.update_period_s().numpy(),
                               ref.update_period_s(), rtol=RTOL,
                               equal_nan=True)
    # the corrected window energy is the better estimate of the truth
    truth = gt.TimelineBank.from_timeline(
        _port_timeline(tl), len(NAMES), torch.as_tensor(shifts),
        device=CPU).integral(torch.as_tensor(a), torch.as_tensor(b))
    assert truth.shape == (len(NAMES),)
