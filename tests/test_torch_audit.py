"""The port's batched fleet audit against the JAX package's numpy tier:
the audit's engine ops, ``SensorBank`` with every transient kind, the
batched naive and §5 protocols and ``fleet_audit`` itself.

Same inputs go through both packages.  The hidden parameters (and the
model gain of estimation rows) come across from the reference's banks
through ``repro_torch.convert``; where a test keeps the reading noise,
the port's ``SensorBank._noise`` is replaced by the reference's draws,
and the §5 start offsets by the reference's (``meter._trial_starts``).
Tolerances, per test:

* engine ops: counters and slots bitwise, floats rtol = atol = 1e-12;
* readings: bitwise, within 1e-12 where the filter's ``exp`` enters;
* energies: rtol 1e-12 plus atol 1e-9 J, because ``integrate_polled``
  contracts ``Σ vals·counts`` in PyTorch's order and numpy sums
  pairwise; relative errors atol 1e-12.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_draws  # noqa: E402
from test_engine_backend import DEGENERATE, _per_device_timelines  # noqa: E402

from repro.core import fleet_engine as rfe  # noqa: E402
from repro.core import load as rload  # noqa: E402
from repro.core import meter as rmeter  # noqa: E402
from repro.core import profiles as rprofiles  # noqa: E402
from repro.core.calibrate import nominal_record as r_nominal  # noqa: E402
from repro.core.engine_backend import numpy_backend as nb  # noqa: E402
from repro.core.engine_backend.pytrees import PollGrid as RGrid  # noqa: E402
from repro.core.ground_truth import ActivityTimeline as RTimeline  # noqa: E402
from repro.core.ground_truth import TimelineBank as RTBank  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fleet_engine as fe  # noqa: E402
from repro_torch.core import ground_truth as gt  # noqa: E402
from repro_torch.core import load as ploads  # noqa: E402
from repro_torch.core import meter as pm  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.core.calibrate import nominal_record  # noqa: E402
from repro_torch.engine_backend import torch_backend as tb  # noqa: E402
from repro_torch.engine_backend.pytrees import (  # noqa: E402
    PollGrid, ReadingSchedule, TimelineArrays)

CPU = "cpu"
RTOL = ATOL = 1e-12
E_RTOL, E_ATOL = 1e-12, 1e-9
# the reference's MIXED fleet (tests/test_fleet_engine.py): one of each
# behavioural class, every transient kind
MIXED = ["a100", "h100_average", "v100", "rtx3090_530", "kepler",
         "maxwell", "fermi2", "gh200_gpu", "tpu_v5e_dash"]
# the chip run's fleet: every transient of Fig. 14 and a module-scope row
AUDIT = ["a100", "h100_instant", "v100", "kepler", "maxwell", "fermi2",
         "gh200_module_instant", "rtx3090_530"]
TL = rload.square_wave(0.230, 16, 220.0, 90.0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _tl(tl):
    """A reference ActivityTimeline as the port's."""
    return gt.ActivityTimeline(torch.as_tensor(tl.edges),
                               torch.as_tensor(tl.powers), tl.idle_w)


def _tbank(bank, device=CPU):
    return gt.TimelineBank(*(torch.as_tensor(x, device=device)
                             for x in (bank.edges, bank.powers, bank.idle_w,
                                       bank.n_segs)))


def _sched(s):
    return ReadingSchedule(*(torch.as_tensor(x) for x in s))


def _carried(rb, noise_w=None):
    """The port's bank with the reference bank ``rb``'s hidden
    parameters; ``noise_w`` overrides both banks' reading jitter."""
    prof = list(rb.profiles)
    if noise_w is not None:
        prof = [dataclasses.replace(profiles.get(p.name), noise_w=noise_w)
                for p in prof]
    else:
        prof = [profiles.get(p.name) for p in prof]
    bank = fe.SensorBank(prof, device=CPU)
    bank._set_hidden(*(torch.as_tensor(x) for x in (
        rb.true_gain, rb.true_offset, rb.true_phase, rb._model_gain)))
    return bank


def _ref_bank(names, seed, noise_w=None):
    prof = [rprofiles.get(n) for n in names]
    if noise_w is not None:
        prof = [dataclasses.replace(p, noise_w=noise_w) for p in prof]
    return rfe.SensorBank(prof, seeds=np.arange(len(names)) + seed)


@pytest.fixture
def reference_draws(monkeypatch):
    """Make the port draw the reference's reading noise and §5 start
    offsets: ``reference_draws(ref_bank)`` routes every port bank's noise
    to the rows of ``ref_bank`` it holds."""
    holder = {}
    _torch_draws.substitute(monkeypatch,
                            lambda bank: holder["ref"].subset(bank._rows))

    def use(ref_bank):
        holder["ref"] = ref_bank
    return use


def _carry_fleet(monkeypatch, use_reference):
    """Make the port's ``fleet_audit`` build its fleet from the
    reference's hidden parameters (and noise, via ``reference_draws``)."""
    def fleet_bank(names, seed, device):
        ref = rfe.SensorBank.from_catalog(list(names),
                                          seeds=np.arange(len(names)) + seed)
        use_reference(ref)
        return convert.sensor_bank(names, ref.true_gain, ref.true_offset,
                                   ref.true_phase,
                                   model_gain=ref._model_gain,
                                   device=device)
    monkeypatch.setattr(fe, "_fleet_bank", fleet_bank)


# ---------------------------------------------------------------------------
# engine ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True])
def test_plain_estimation_means_matches_numpy(shared):
    tls = RTBank.from_timelines([TL] if shared
                                else _per_device_timelines(6, seed=3))
    rng = np.random.default_rng(0)
    t1 = rng.uniform(-0.5, 4.0, size=(6, 40))
    t0 = t1 - 0.1
    mg = rng.uniform(0.85, 1.15, 6)
    ref = nb.estimation_means(tls.arrays, t0, t1, mg)
    got = tb.estimation_means(TimelineArrays(*(torch.as_tensor(x) for x in
                                               tls.arrays)),
                              torch.as_tensor(t0), torch.as_tensor(t1),
                              torch.as_tensor(mg))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def _poll_case(offset, a, b):
    rb = rfe.SensorBank.from_catalog(MIXED, base_seed=17)
    rb.attach(TL, t_end=5.0)
    n = rb.n_devices
    return rb._schedule, RGrid(0.0, np.full(n, 4.0), 0.001,
                               np.broadcast_to(offset, (n,)).copy()), a, b


def _poll_cases():
    rng = np.random.default_rng(3)
    n = len(MIXED)
    a = rng.uniform(0.0, 2.0, size=n)
    b = a + rng.uniform(0.0, 2.0, size=n)
    cases = [("shared_offset", -0.025, a, b),
             ("per_device_offset", -rng.uniform(0.0, 0.1, n), a, b),
             ("past_grid_end", 0.0, a, a + 5.0)]
    cases += [(name, 0.0, np.full(n, lo), np.full(n, hi))
              for name, lo, hi in DEGENERATE]
    return cases


@pytest.mark.parametrize("name, offset, a, b", _poll_cases(),
                         ids=[c[0] for c in _poll_cases()])
def test_plain_poll_counts_matches_numpy(name, offset, a, b):
    sched, grid, a, b = _poll_case(offset, a, b)
    ref = nb.poll_counts(sched, grid, a, b)
    got = tb.poll_counts(_sched(sched),
                         PollGrid(grid.t0, torch.as_tensor(grid.t1),
                                  grid.period_s,
                                  torch.as_tensor(grid.grid_offset)),
                         torch.as_tensor(a), torch.as_tensor(b))
    for label, r, g in zip(("counts", "slot_b", "tail_dt", "nonempty"),
                           ref, got):
        if label == "tail_dt":
            np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=label)


# ---------------------------------------------------------------------------
# timelines, loads, trains
# ---------------------------------------------------------------------------

def test_timeline_composition_is_bitwise_the_reference():
    tl = rload.multi_phase_workload([(0.13, 215.0), (0.07, 165.0)])
    ptl = ploads.multi_phase_workload([(0.13, 215.0), (0.07, 165.0)])
    np.testing.assert_array_equal(ptl.edges.numpy(), tl.edges)
    sw = ploads.square_wave(0.230, 16, 220.0, 90.0)
    np.testing.assert_array_equal(sw.edges.numpy(), TL.edges)
    np.testing.assert_array_equal(sw.powers.numpy(), TL.powers)
    for got, want in ((ptl.repeat(5), tl.repeat(5)),
                      (gt.ActivityTimeline.concat([ptl, sw.shift(3.0)],
                                                  gap_s=0.025),
                       RTimeline.concat([tl, TL.shift(3.0)], gap_s=0.025))):
        np.testing.assert_array_equal(got.edges.numpy(), want.edges)
        np.testing.assert_array_equal(got.powers.numpy(), want.powers)
        assert got.idle_w == want.idle_w
        assert got.t_start == want.t_start
        assert got.energy() == pytest.approx(want.energy(), rel=RTOL)
    bank = RTBank.from_timelines(_per_device_timelines(5, seed=1))
    pbank = _tbank(bank)
    np.testing.assert_allclose(pbank.energy().numpy(), bank.energy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pbank.t_start.numpy(), bank.t_start)
    np.testing.assert_array_equal(pbank.duration_s.numpy(), bank.duration_s)


@pytest.mark.parametrize("reps, shifts", [(32, 8), (33, 8), (5, 8), (40, 0)])
def test_repetition_trains_match_the_reference(reps, shifts):
    tl = rload.multi_phase_workload([(0.13, 215.0), (0.07, 165.0)])
    W = 0.025
    want = rmeter._build_train(tl, reps, shifts, W)
    got = pm._build_train(_tl(tl), reps, shifts, W)
    np.testing.assert_array_equal(got.edges.numpy(), want.edges)
    np.testing.assert_array_equal(got.powers.numpy(), want.powers)
    e_ref, p_ref = rmeter._train_arrays(tl, reps, shifts, W)
    e_got, p_got = pm._train_arrays(_tl(tl), reps, shifts, W)
    np.testing.assert_array_equal(e_got.numpy(), e_ref)
    np.testing.assert_array_equal(p_got.numpy(), p_ref)
    for i0, i1 in ((0, reps), (min(3, reps - 1), reps)):
        assert (pm._gaps_between(i0, i1, shifts, reps)
                == rmeter._gaps_between(i0, i1, shifts, reps))
        assert (pm._train_offset(i0, 0.2, shifts, reps, W)
                == rmeter._train_offset(i0, 0.2, shifts, reps, W))


def test_trial_starts_follow_the_seed_alone():
    full = pm._trial_starts(np.arange(10), 3)
    part = pm._trial_starts(np.array([7, 2, 9]), 3)
    assert torch.equal(part, full[[7, 2, 9]])
    assert torch.equal(pm._trial_starts(np.array([2]), 3)[0], full[2])
    assert bool(((full >= 0) & (full < 1)).all())
    with pytest.raises(ValueError, match="non-negative"):
        pm._trial_starts(np.array([-1]), 2)


# ---------------------------------------------------------------------------
# SensorBank with every transient kind
# ---------------------------------------------------------------------------

def _readings_match(rb, bank):
    np.testing.assert_array_equal(bank._ticks.numpy(), rb._ticks)
    np.testing.assert_array_equal(bank._first.numpy(), rb._first)
    np.testing.assert_array_equal(bank._last.numpy(), rb._last)
    log = rb.transient == "logarithmic"
    np.testing.assert_array_equal(bank._values.numpy()[~log],
                                  rb._values[~log])
    np.testing.assert_allclose(bank._values.numpy()[log], rb._values[log],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("timeline", ["shared", "shifted", "per_device"])
def test_attach_mixed_fleet_is_the_reference(timeline):
    """Noise-free, hidden parameters and model gain carried across."""
    rb = _ref_bank(MIXED, 11, noise_w=0.0)
    bank = _carried(rb, noise_w=0.0)
    n = len(MIXED)
    if timeline == "per_device":
        rtl = RTBank.from_timelines(_per_device_timelines(n, seed=4))
        rb.attach(rtl)
        bank.attach(_tbank(rtl))
    else:
        shifts = (np.random.default_rng(1).uniform(0.0, 0.5, n)
                  if timeline == "shifted" else None)
        rb.attach(TL, t_end=5.0, shifts=shifts)
        bank.attach(_tl(TL), t_end=5.0,
                    shifts=None if shifts is None else torch.as_tensor(shifts))
    _readings_match(rb, bank)
    tq = np.linspace(-0.5, 5.0, 301)
    np.testing.assert_allclose(bank.query(torch.as_tensor(tq)).numpy(),
                               rb.query(tq), rtol=RTOL, atol=ATOL)


def test_attach_carries_the_reference_noise(reference_draws):
    rb = _ref_bank(MIXED, 5)
    reference_draws(rb)
    bank = _carried(rb)
    rb.attach(TL, t_end=5.0)
    bank.attach(_tl(TL), t_end=5.0)
    _readings_match(rb, bank)


def test_port_noise_is_aligned_to_valid_slots():
    bank = fe.SensorBank.from_catalog(["v100"] * 400, seed=3, device=CPU)
    first = torch.randint(0, 5, (400,))
    count = torch.randint(50, 90, (400,))
    z = bank._noise(100, first, count)
    cols = torch.arange(100)[None, :]
    valid = (cols >= first[:, None]) & (cols < (first + count)[:, None])
    assert bool((z[~valid] == 0).all())
    # 0.15 W jitter: the sample std of ~28k draws is within 3 %
    assert float(z[valid].std()) == pytest.approx(0.15, rel=0.03)
    assert torch.equal(z, bank._noise(100, first, count))
    # a subset draws its fleet rows' noise, whatever slab holds them
    other = bank.subset(np.arange(200, 400))._noise(100, first[200:],
                                                    count[200:])
    assert torch.equal(other, z[200:])


def test_subset_slices_every_row_field():
    bank = fe.SensorBank.from_catalog(AUDIT * 2, seed=9, device=CPU)
    idx = np.array([3, 4, 5, 12, 13])
    sub = bank.subset(idx)
    assert [p.name for p in sub.profiles] == [AUDIT[i % 8] for i in idx]
    for f in fe.SensorBank._ROW_FIELDS:
        a, b = getattr(sub, f), getattr(bank, f)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b[torch.as_tensor(idx)]), f
        else:
            np.testing.assert_array_equal(a, b[idx], err_msg=f)
    est = sub.transient == "estimation"
    assert bool((sub._model_gain[torch.as_tensor(~est)] == 1.0).all())
    dev = (sub._model_gain[torch.as_tensor(est)] - 1.0).abs()
    assert 0.0 < float(dev.max()) <= 0.15


def test_bank_round_trips_through_convert():
    rb = _ref_bank(AUDIT, 2)
    bank = convert.sensor_bank(AUDIT, rb.true_gain, rb.true_offset,
                               rb.true_phase, model_gain=rb._model_gain,
                               device=CPU)
    back = convert.bank_to_numpy(bank)
    for key, want in (("true_gain", rb.true_gain),
                      ("true_offset", rb.true_offset),
                      ("true_phase", rb.true_phase),
                      ("model_gain", rb._model_gain)):
        np.testing.assert_array_equal(back[key], want)


def test_entry_points_refuse_a_missing_card_and_name_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fe.SensorBank.from_catalog(["kepler", "maxwell", "fermi2"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fe.fleet_audit(3, ["kepler", "maxwell", "fermi2"])
    fe.SensorBank.from_catalog(["kepler", "maxwell", "fermi2"], device=CPU)


class _ModelMesh:
    """A stand-in for a mesh whose only dimension is not ``"data"``."""
    mesh_dim_names = ("model",)


@pytest.mark.parametrize("mesh", [object(), _ModelMesh()],
                         ids=["no_dimensions", "model_only"])
def test_a_mesh_without_data_raises_and_names_data_mesh(mesh):
    with pytest.raises(ValueError, match="data_mesh"):
        fe.fleet_audit(4, "a100", mesh=mesh, device=CPU)


# ---------------------------------------------------------------------------
# integrate_polled and the batched protocols
# ---------------------------------------------------------------------------

def test_integrate_polled_matches_reference():
    """Per-device poll ends, per-device offsets and a transform."""
    rb = _ref_bank(MIXED, 21, noise_w=0.0)
    bank = _carried(rb, noise_w=0.0)
    rb.attach(TL, t_end=5.0)
    bank.attach(_tl(TL), t_end=5.0)
    rng = np.random.default_rng(8)
    n = len(MIXED)
    a = rng.uniform(0.0, 2.0, n)
    b = a + rng.uniform(0.0, 2.5, n)
    t1 = rng.uniform(3.0, 4.5, n)
    off = -rng.uniform(0.0, 0.1, n)
    base = rng.uniform(0.0, 20.0, n)
    want = rb.integrate_polled(0.0, t1, 0.001, a, b,
                               transform=lambda v: v - base[:, None],
                               grid_offset=off)
    tbase = torch.as_tensor(base)[:, None]
    got = bank.integrate_polled(0.0, torch.as_tensor(t1), 0.001,
                                torch.as_tensor(a), torch.as_tensor(b),
                                transform=lambda v: v - tbase,
                                grid_offset=torch.as_tensor(off))
    np.testing.assert_allclose(got.numpy(), want, rtol=E_RTOL, atol=E_ATOL)


def _workloads(n, seed=4):
    rng = np.random.default_rng(seed)
    rws = [rmeter.Workload(
        f"w{i}", rload.multi_phase_workload(
            [(float(rng.uniform(0.05, 0.3)), float(rng.uniform(100, 250))),
             (float(rng.uniform(0.02, 0.2)), float(rng.uniform(70, 200)))]),
        scenario="train" if i % 3 else "serve") for i in range(n)]
    pws = [pm.Workload(w.name, _tl(w.timeline), scenario=w.scenario)
           for w in rws]
    return rws, pws


def _audit_workload():
    tl = rload.multi_phase_workload([(0.130, 215.0), (0.070, 165.0)])
    return rmeter.Workload("audit_burst", tl), pm.Workload("audit_burst",
                                                           _tl(tl))


@pytest.mark.parametrize("module_rows", [False, True])
@pytest.mark.parametrize("per_device", [False, True])
def test_measure_batches_match_reference(reference_draws, per_device,
                                         module_rows):
    """Naive and §5 protocols, shared workload or WorkloadSet, with a
    25 W host baseline debited from the module-scope rows."""
    names = AUDIT if module_rows else [n for n in AUDIT
                                       if n != "gh200_module_instant"]
    names = names * 2
    rb = _ref_bank(names, 6)
    reference_draws(rb)
    bank = _carried(rb)
    if per_device:
        rwl, pwl = _workloads(len(names))
        pwl = pm.WorkloadSet(pwl, device=CPU)
    else:
        rwl, pwl = _audit_workload()
    baseline = 25.0 if module_rows else None
    want = rmeter.measure_naive_batch(rb, rwl, host_baseline_w=baseline)
    got = pm.measure_naive_batch(bank, pwl, host_baseline_w=baseline)
    np.testing.assert_allclose(got.numpy(), want, rtol=E_RTOL, atol=E_ATOL)

    cal = {n: r_nominal("fleet", rprofiles.get(n)) for n in set(names)}
    pcal = {n: nominal_record("fleet", profiles.get(n)) for n in set(names)}
    cfg = rmeter.GoodPracticeConfig(n_trials=3)
    seeds = np.arange(len(names)) + 40
    want = rmeter.measure_good_practice_batch(
        rb, rwl, cal, cfg, host_baseline_w=baseline, seeds=seeds)
    got = pm.measure_good_practice_batch(
        bank, pwl, pcal, pm.GoodPracticeConfig(n_trials=3),
        host_baseline_w=baseline, seeds=seeds)
    np.testing.assert_allclose(got.trial_values.numpy(), want.trial_values,
                               rtol=E_RTOL, atol=E_ATOL)
    np.testing.assert_allclose(got.joules_per_rep.numpy(),
                               want.joules_per_rep, rtol=E_RTOL, atol=E_ATOL)
    np.testing.assert_allclose(got.std_j.numpy(), want.std_j, rtol=1e-9,
                               atol=E_ATOL)
    np.testing.assert_array_equal(got.n_reps.numpy(), want.n_reps)


def test_module_scope_needs_a_baseline():
    bank = fe.SensorBank.from_catalog(["a100", "gh200_module_instant"],
                                      device=CPU)
    _, wl = _audit_workload()
    with pytest.raises(pm.ModuleScopeError, match="gh200_module_instant"):
        pm.measure_naive_batch(bank, wl)


# ---------------------------------------------------------------------------
# the whole slice: fleet_audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("per_device", [False, True])
def test_fleet_audit_matches_reference(monkeypatch, reference_draws,
                                       per_device, chunk):
    """48 devices of every transient kind and a module-scope row; the
    fleet's hidden parameters, noise and §5 offsets the reference's."""
    _carry_fleet(monkeypatch, reference_draws)
    names = AUDIT * 6
    n = len(names)
    if per_device:
        rwl, pwl = _workloads(n)
    else:
        rwl, pwl = None, None
    want = rfe.fleet_audit(n, names, workload=rwl, seed=3,
                           good_practice=True, backend="numpy",
                           chunk_devices=chunk)
    got = fe.fleet_audit(n, names, workload=pwl, seed=3, good_practice=True,
                         chunk_devices=chunk, device=CPU)
    for key in ("naive_j", "gp_j"):
        np.testing.assert_allclose(_np(getattr(got, key)),
                                   getattr(want, key), rtol=E_RTOL,
                                   atol=E_ATOL, err_msg=key)
    for key in ("naive_err", "gp_err"):
        np.testing.assert_allclose(_np(getattr(got, key)),
                                   getattr(want, key), rtol=0, atol=1e-12,
                                   err_msg=key)
    np.testing.assert_allclose(_np(got.true_j), want.true_j, rtol=RTOL)
    for errs in ("naive_err", "gp_err"):
        g = got.stats(getattr(got, errs))
        w = want.stats(getattr(want, errs))
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-9, abs=1e-12), k
    if per_device:
        np.testing.assert_array_equal(got.scenarios, want.scenarios)
        g, w = got.by_scenario(got.gp_err), want.by_scenario(want.gp_err)
        assert set(g) == set(w)
        for label in w:
            for k in w[label]:
                assert g[label][k] == pytest.approx(w[label][k], rel=1e-9,
                                                    abs=1e-12)
    gu, wu = got.uncertainty(), want.uncertainty()
    for k in wu:
        assert gu[k] == pytest.approx(wu[k], rel=1e-12)


@pytest.mark.parametrize("noisy", [False, True], ids=["noise_free",
                                                    "catalog_noise"])
def test_fleet_audit_chunking_invariance(monkeypatch, noisy):
    """A chunked audit draws the unchunked one's hidden parameters, start
    offsets and (keyed by fleet row) reading noise, the port's own draws,
    so per device the two agree to 1e-12, with the catalog's 0.15 W
    noise as without it."""
    if not noisy:
        def quiet_fleet(names, seed, device):
            return fe.SensorBank([dataclasses.replace(profiles.get(n),
                                                      noise_w=0.0)
                                  for n in names], seed=seed, device=device)
        monkeypatch.setattr(fe, "_fleet_bank", quiet_fleet)
    names = AUDIT * 6
    n = len(names)
    whole = fe.fleet_audit(n, names, seed=5, good_practice=True, device=CPU)
    chunked = fe.fleet_audit(n, names, seed=5, good_practice=True,
                             chunk_devices=n // 3, device=CPU)
    for key in ("naive_j", "gp_j"):
        np.testing.assert_allclose(getattr(chunked, key).numpy(),
                                   getattr(whole, key).numpy(), rtol=1e-12,
                                   atol=0.0, err_msg=key)


def test_streamed_moments_agree_with_exact_stats():
    names = AUDIT * 6
    res = fe.fleet_audit(len(names), names, seed=1, good_practice=True,
                         chunk_devices=10, device=CPU)
    for key, errs in (("naive", res.naive_err), ("good_practice",
                                                 res.gp_err)):
        st = res.stats(errs)
        sm = res.streamed[key]["overall"]
        assert sm["n_devices"] == len(names)
        for k in ("mean_err", "mean_abs_err", "std_err", "worst_abs"):
            assert sm[k] == pytest.approx(st[k], abs=1e-9), (key, k)
    # §5 recovers most of what the naive protocol misses on this fleet
    assert (res.stats(res.gp_err)["mean_abs_err"]
            < res.stats()["mean_abs_err"])


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 2**24 + 1])
def test_err_stats_percentiles_are_numpys(n):
    """``stats()`` takes its percentiles by one sort, with
    ``np.percentile``'s interpolation: the same numbers, also above the
    2^24 elements ``torch.quantile`` refuses."""
    e = np.random.default_rng(n).normal(0.0, 0.05, n)
    if n == 7:
        e[:4] = 0.02                                # ties
    res = fe.FleetAuditResult(n_devices=n, profile_names=[], true_j=1.0,
                              naive_j=torch.ones(1),
                              naive_err=torch.as_tensor(e))
    st = res.stats()
    ae = np.abs(e)
    for key, q in (("p50_abs", 50), ("p90_abs", 90), ("p99_abs", 99)):
        assert st[key] == np.percentile(ae, q), key
    assert st["worst_abs"] == ae.max()
    assert st["mean_abs_err"] == pytest.approx(ae.mean(), rel=1e-12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the audit's log_filter kernel has no "
                    "CPU mode (chip_smoke.py runs the audit on the card)")
    return torch.device("cuda")


def test_cuda_fleet_audit_matches_the_cpu_plain_path(cuda):
    names = AUDIT * 12
    out = [fe.fleet_audit(len(names), names, seed=2, good_practice=True,
                          chunk_devices=40, device=d) for d in (cuda, CPU)]
    for key in ("naive_j", "gp_j"):
        np.testing.assert_allclose(_np(getattr(out[0], key)),
                                   _np(getattr(out[1], key)), rtol=1e-12,
                                   atol=E_ATOL, err_msg=key)
