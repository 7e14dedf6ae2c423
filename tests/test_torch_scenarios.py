"""The port's mixed-fleet scenarios against the JAX package's numpy tier
(``repro.core.load``), and ``fleet_audit``/``stream_fleet`` over a
``FleetScenarioSpec`` against the reference's.

The port draws each device's shape from its keyed stream; the reference
from ``default_rng(seed_i)`` (``VecStreams``).  With the reference's draws
carried in through ``load._scenario_streams``
(``substitute_scenarios`` below), every bank must be the
reference's: bitwise for training, inference, idle, powercap and
node_failure; within 1e-15 relative for diurnal, dvfs and throttle, whose
``sin``/``pow``/``exp`` may differ from numpy's by an ulp.  Without
carried draws the port is checked alone: durations, segment counts and
the independence of a device's draws from the other devices in a call.
The audit and the stream carry the fleet's hidden parameters, noise and
§5 offsets too (``test_torch_audit._carry_fleet``), under that file's
bars.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from test_torch_audit import (AUDIT, E_ATOL, E_RTOL,  # noqa: E402,F401
                              _carry_fleet, reference_draws)

from repro.core import fleet_engine as rfe  # noqa: E402
from repro.core import load as rload  # noqa: E402
from repro.core.engine_backend.vecrng import VecStreams  # noqa: E402
from repro_torch.core import fleet_engine as fe  # noqa: E402
from repro_torch.core import load as loads  # noqa: E402
from repro_torch.core import meter as pm  # noqa: E402
from repro_torch.core.ground_truth import TimelineBank  # noqa: E402
from repro_torch.core.meter import Workload, WorkloadSet  # noqa: E402
from repro_torch.core.stream import stream_fleet  # noqa: E402
from repro_torch.engine_backend import keyed_rng  # noqa: E402

# the module (``repro.core.stream.replay`` is also the function's name)
rreplay_mod = importlib.import_module("repro.core.stream.replay")
CPU = "cpu"
KINDS = sorted(loads.SCENARIOS)
#: kinds whose powers go through sin, pow or exp
ULP_KINDS = {"diurnal", "dvfs", "throttle"}
ULP_RTOL = 1e-15
#: each kind's window (training's duration varies by design) and its
#: segment counts
WINDOW_S = {"inference": 0.350, "idle": 0.450, "diurnal": 0.300,
            "dvfs": 0.360, "throttle": 0.420, "powercap": 0.400,
            "node_failure": 0.400}
SEGMENTS = {"training": (2, 2), "inference": (1, 25), "idle": (3, 3),
            "diurnal": (6, 6), "dvfs": (8, 8), "throttle": (7, 7),
            "powercap": (8, 8), "node_failure": (2, 2)}


class ReferenceScenarioStreams:
    """The port's ``ScenarioStreams`` interface over the reference's
    ``VecStreams``: lane ``i`` draws ``default_rng(seeds[i])``'s numbers,
    as the reference's banks do.  Blocks come back zero-padded to the
    port's fixed width, and the Poisson count clipped at ``cap``."""

    def __init__(self, seeds, device):
        self._vs = VecStreams(np.asarray(_np(seeds)))
        self.device = torch.device(device)

    @property
    def n_lanes(self):
        return self._vs.n_lanes

    def _t(self, x):
        return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

    def _padded(self, x, width):
        out = np.zeros((x.shape[0], width))
        out[:, :x.shape[1]] = x
        return self._t(out)

    def uniform(self, lo, hi):
        return self._t(self._vs.uniform(_np(lo), _np(hi)))

    def uniform_block(self, lo, hi, counts, width):
        return self._padded(self._vs.uniform_block(lo, hi, _np(counts)),
                            width)

    def exponential_block(self, scale, counts, width):
        return self._padded(self._vs.exponential_block(scale, _np(counts)),
                            width)

    def poisson(self, lam, cap):
        return self._t(np.minimum(self._vs.poisson(lam), cap))


def substitute_scenarios(monkeypatch):
    """Every scenario draw of the port as the reference's."""
    monkeypatch.setattr(loads, "_scenario_streams", ReferenceScenarioStreams)


@pytest.fixture
def carried(monkeypatch):
    """The reference's scenario draws in the port's banks."""
    substitute_scenarios(monkeypatch)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def assert_bank_equal(got, want, kind=None, label=""):
    """A port bank against a reference bank: shapes, segment counts and
    edges bitwise; powers bitwise, or within ``ULP_RTOL`` for the kinds
    that take a transcendental (``kind`` None: a mixed bank)."""
    for f in ("edges", "n_segs", "idle_w"):
        np.testing.assert_array_equal(_np(getattr(got, f)), getattr(want, f),
                                      err_msg=f"{label} {f}")
    p, w = _np(got.powers), want.powers
    assert p.shape == w.shape, label
    if kind is not None and kind not in ULP_KINDS:
        np.testing.assert_array_equal(p, w, err_msg=f"{label} powers")
    else:
        np.testing.assert_allclose(p, w, rtol=ULP_RTOL, atol=0.0,
                                   err_msg=f"{label} powers")


def assert_timeline_equal(got, want, kind, label=""):
    np.testing.assert_array_equal(_np(got.edges), want.edges, err_msg=label)
    if kind in ULP_KINDS:
        np.testing.assert_allclose(_np(got.powers), want.powers,
                                   rtol=ULP_RTOL, atol=0.0, err_msg=label)
    else:
        np.testing.assert_array_equal(_np(got.powers), want.powers,
                                      err_msg=label)
    assert got.idle_w == want.idle_w


# ---------------------------------------------------------------------------
# the banks against the reference's, draws carried
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_bank_matches_reference(carried, kind):
    seeds = np.arange(160) * 911 + 5
    want = rload.scenario_bank(kind, seeds)
    got = loads.scenario_bank(kind, seeds, device=CPU)
    assert isinstance(got, TimelineBank) and got.device.type == "cpu"
    assert_bank_equal(got, want, kind, kind)


@pytest.mark.parametrize("kind", KINDS)
@given(seed=st.integers(min_value=0, max_value=2**32),
       idle=st.floats(40.0, 80.0), peak=st.floats(200.0, 400.0))
@settings(max_examples=15, deadline=None)
def test_property_bank_matches_reference(kind, seed, idle, peak):
    with pytest.MonkeyPatch.context() as mp:
        substitute_scenarios(mp)
        seeds = np.array([seed, seed + 1])
        want = rload.SCENARIO_BANKS[kind](seeds, idle_w=idle, peak_w=peak)
        got = loads.SCENARIO_BANKS[kind](seeds, idle_w=idle, peak_w=peak,
                                         device=CPU)
        assert_bank_equal(got, want, kind, f"{kind} {seed} {idle} {peak}")


@pytest.mark.parametrize("rate_hz", [0.5, 200.0], ids=["k0", "clip"])
def test_inference_at_zero_and_clipped_bursts(carried, rate_hz):
    """rate 0.5 leaves most windows without a request (k = 0: one idle
    segment); rate 200 clips every window at 12 bursts."""
    seeds = np.arange(300)
    want = rload.inference_serving_bank(seeds, rate_hz=rate_hz)
    got = loads.inference_serving_bank(seeds, rate_hz=rate_hz, device=CPU)
    assert_bank_equal(got, want, "inference")
    if rate_hz < 1.0:
        assert int((got.n_segs == 1).sum()) > 100
    else:
        assert int(got.n_segs.max()) > 12


def test_inference_max_bursts_is_the_references(carried):
    raised = loads.inference_serving_bank([3], rate_hz=200.0, max_bursts=64,
                                          device=CPU)
    assert_bank_equal(raised, rload.inference_serving_bank(
        np.array([3]), rate_hz=200.0, max_bursts=64), "inference")
    with pytest.raises(ValueError, match="max_bursts"):
        loads.inference_serving_timeline(seed=0, max_bursts=0)
    with pytest.raises(ValueError, match="max_bursts"):
        loads.inference_serving_bank(np.arange(3), max_bursts=0, device=CPU)


@pytest.mark.parametrize("kind", KINDS)
def test_scenario_timeline_matches_reference_scalar(carried, kind):
    """The scalar generator (row 0 of the bank at [seed]) against the
    reference's ``default_rng(seed)`` generator."""
    for seed in (0, 1, 17, 2**31 + 5):
        assert_timeline_equal(loads.scenario_timeline(kind, seed),
                              rload.scenario_timeline(kind, seed), kind,
                              f"{kind} {seed}")
    with pytest.raises(KeyError, match="unknown scenario"):
        loads.scenario_timeline("nope")


@pytest.mark.parametrize("n", [1, 7, 100, 1001])
@pytest.mark.parametrize("mix", [None, rload.ADVERSARIAL_MIX,
                                 {"training": 1.0, "idle": 2.0}],
                         ids=["default", "adversarial", "two"])
def test_mix_labels_are_the_references(mix, n):
    np.testing.assert_array_equal(loads._mix_labels(n, mix, 7),
                                  rload._mix_labels(n, mix, 7))


def test_mix_constants_are_the_references():
    assert loads.DEFAULT_MIX == rload.DEFAULT_MIX
    assert loads.ADVERSARIAL_MIX == rload.ADVERSARIAL_MIX
    assert sorted(loads.SCENARIOS) == sorted(rload.SCENARIOS)
    assert sorted(loads.SCENARIO_BANKS) == sorted(rload.SCENARIO_BANKS)
    with pytest.raises(KeyError, match="unknown scenario"):
        loads._mix_labels(3, {"bogus": 1.0}, 0)
    with pytest.raises(ValueError, match="sum to > 0"):
        loads._mix_labels(3, {"idle": 0.0}, 0)
    with pytest.raises(ValueError, match="at least one device"):
        loads._mix_labels(0, None, 0)


@pytest.mark.parametrize("mix", [None, rload.ADVERSARIAL_MIX],
                         ids=["default", "adversarial"])
def test_mixed_fleet_bank_matches_reference(carried, mix):
    want, wl = rload.mixed_fleet_bank(300, mix=mix, seed=7)
    got, gl = loads.mixed_fleet_bank(300, mix=mix, seed=7, device=CPU)
    np.testing.assert_array_equal(gl, wl)
    assert_bank_equal(got, want, None, "mixed")
    want, wl = rload.mixed_fleet_bank(300, mix=mix, seed=7, lo=60, hi=140)
    got, gl = loads.mixed_fleet_bank(300, mix=mix, seed=7, lo=60, hi=140,
                                     device=CPU)
    np.testing.assert_array_equal(gl, wl)
    assert_bank_equal(got, want, None, "slab")


def test_mixed_fleet_slab_equals_full_rows():
    n = 200
    full, labels = loads.mixed_fleet_bank(n, seed=3, device=CPU)
    slab, sl = loads.mixed_fleet_bank(n, seed=3, lo=60, hi=140, device=CPU)
    np.testing.assert_array_equal(sl, labels[60:140])
    for g, i in enumerate(range(60, 140)):
        a, b = slab.row(g), full.row(i)
        assert torch.equal(a.edges, b.edges) and torch.equal(a.powers,
                                                             b.powers)
    with pytest.raises(ValueError, match="bad slab"):
        loads.mixed_fleet_bank(10, lo=5, hi=3, device=CPU)


def test_object_path_is_the_bank_and_the_scalar_generators():
    n = 60
    wls = loads.mixed_fleet_workloads(n, seed=7, device=CPU)
    ws = loads.mixed_fleet_workloads(n, seed=7, as_bank=True, device=CPU)
    assert isinstance(ws, WorkloadSet) and len(ws) == n
    for i, w in enumerate(wls):
        assert isinstance(w, Workload)
        assert w.scenario == ws.scenarios[i] and w.name == f"{w.scenario}[{i}]"
        row = ws.timeline_bank.row(i)
        assert torch.equal(w.timeline.edges, row.edges)
        assert torch.equal(w.timeline.powers, row.powers)
        if i % 10 == 0:
            tl = loads.scenario_timeline(w.scenario, seed=7 + 1 + i)
            assert torch.equal(w.timeline.edges, tl.edges)
            assert torch.equal(w.timeline.powers, tl.powers)
    torch.testing.assert_close(ws.true_energies_j, torch.tensor(
        [w.true_energy_j for w in wls], dtype=torch.float64), rtol=1e-12,
        atol=0.0)


def test_mixed_fleet_workloads_match_reference(carried):
    want = rload.mixed_fleet_workloads(40, seed=9)
    got = loads.mixed_fleet_workloads(40, seed=9, device=CPU)
    for g, w in zip(got, want):
        assert g.name == w.name and g.scenario == w.scenario
        assert_timeline_equal(g.timeline, w.timeline, g.scenario, g.name)


# ---------------------------------------------------------------------------
# FleetScenarioSpec
# ---------------------------------------------------------------------------

def test_fleet_scenario_spec_validation_and_slabs():
    with pytest.raises(ValueError, match="at least one device"):
        loads.FleetScenarioSpec(n=0)
    with pytest.raises(KeyError, match="unknown scenario"):
        loads.FleetScenarioSpec(n=5, mix={"bogus": 1.0})
    spec = loads.FleetScenarioSpec(n=50, seed=2)
    full = spec.workload_set(device=CPU)
    part = spec.workload_set(10, 30, device=CPU)
    np.testing.assert_array_equal(part.scenarios, full.scenarios[10:30])
    assert torch.equal(part.true_energies_j, full.true_energies_j[10:30])
    assert torch.equal(part.durations_s, full.durations_s[10:30])


@pytest.mark.parametrize("slabs", [[(0, 50)], [(0, 17), (17, 34), (34, 50)],
                                   [(0, 1), (1, 49), (49, 50)]])
def test_prefetched_slabs_are_the_sequential_ones(slabs):
    spec = loads.FleetScenarioSpec(n=50, mix=rload.ADVERSARIAL_MIX, seed=4)
    seq = list(spec.iter_workload_sets(slabs, device=CPU))
    pre = list(spec.iter_workload_sets(slabs, prefetch=True, device=CPU))
    assert len(seq) == len(pre) == len(slabs)
    for a, b in zip(seq, pre):
        for f in ("edges", "powers", "n_segs"):
            assert torch.equal(getattr(a.timeline_bank, f),
                               getattr(b.timeline_bank, f))
        np.testing.assert_array_equal(a.scenarios, b.scenarios)


# ---------------------------------------------------------------------------
# the port alone: shapes and truths of its own draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_own_draws_durations_and_segments(kind):
    seeds = np.arange(2000) + 11
    bank = loads.scenario_bank(kind, seeds, device=CPU)
    lo, hi = SEGMENTS[kind]
    ns = bank.n_segs
    assert int(ns.min()) >= lo and int(ns.max()) <= hi
    e = bank.edges
    assert bool((e[:, 0] == 0.0).all())
    assert bool((torch.diff(e, dim=1) >= 0.0).all())
    assert bool(torch.isfinite(bank.powers).all())
    assert bool((bank.powers >= 0.0).all())
    dur = bank.duration_s
    if kind == "training":
        assert float(dur.min()) >= 0.14 and float(dur.max()) <= 0.24
    else:
        w = WINDOW_S[kind]
        torch.testing.assert_close(dur, torch.full_like(dur, w), rtol=1e-15,
                                   atol=0.0)
    if kind == "inference":
        assert int((ns == 1).sum()) > 0 or int(ns.max()) > 1


@pytest.mark.parametrize("kind", KINDS)
def test_own_draws_depend_on_the_seed_alone(kind):
    """A row's shape is the same whichever seeds share the call."""
    a = loads.scenario_bank(kind, [5, 6, 7, 8], device=CPU)
    b = loads.scenario_bank(kind, [99, 7, 1234567, 5, 3], device=CPU)
    for i, j in ((0, 3), (2, 1)):
        ra, rb = a.row(i), b.row(j)
        assert torch.equal(ra.edges, rb.edges)
        assert torch.equal(ra.powers, rb.powers)
    assert not torch.equal(a.row(0).powers, a.row(1).powers)


def test_keyed_poisson_count_is_poisson_and_clipped_exactly():
    """λ = 4.9 over 10⁵ rows: the mean and the variance within 5 standard
    errors of λ; the count at cap 12 is exactly min(count at cap 60, 12)
    (the first 12 uniforms of both blocks are the same draws)."""
    lam, n = 4.9, 100_000
    seeds = np.arange(n) + 3
    wide = loads.ScenarioStreams(torch.as_tensor(seeds)).poisson(lam, 60)
    k = wide.to(torch.float64)
    se_mean = (lam / n) ** 0.5
    se_var = ((lam + 2 * lam * lam) / n) ** 0.5
    assert abs(float(k.mean()) - lam) < 5 * se_mean
    assert abs(float(k.var()) - lam) < 5 * se_var
    clipped = loads.ScenarioStreams(torch.as_tensor(seeds)).poisson(lam, 12)
    assert torch.equal(clipped, torch.clamp_max(wide, 12))
    assert int(clipped.max()) == 12


def test_log_unit_is_the_log_within_a_few_ulp():
    """The exponentials' log, in +, -, × and ÷ alone, against torch's:
    within 1e-15 relative over keyed uniforms and the ends of (0, 1]."""
    u = keyed_rng.uniform(11, torch.zeros(200_000, dtype=torch.int64),
                          torch.arange(200_000), keyed_rng.TAG_SCENARIO)
    x = torch.cat([1.0 - u, torch.tensor(
        [2.0 ** -53, 2.0 ** -52, 0.5, 0.5 ** 0.5, 1.0 - 2.0 ** -53, 1.0],
        dtype=torch.float64)])
    got, want = loads._log_unit(x), torch.log(x)
    assert float(got[-1]) == 0.0
    nz = want != 0.0
    rel = ((got - want).abs() / want.abs())[nz]
    assert float(rel.max()) <= 1e-15


def test_scenario_streams_take_fixed_slots():
    """Each draw takes the next slot of the keyed stream under the
    device's seed, a block its whole width, whatever the counts."""
    seeds = torch.tensor([3, 10**12 + 7])
    s = loads.ScenarioStreams(seeds)
    u = s.uniform(0.0, 1.0)
    blk = s.uniform_block(2.0, 4.0, torch.tensor([0, 3]), 5)
    after = s.uniform(0.0, 1.0)
    rows = torch.zeros(1, dtype=torch.int64)

    def at(slot):
        return keyed_rng.uniform(seeds, rows, torch.tensor([slot]),
                                 keyed_rng.TAG_SCENARIO)
    assert torch.equal(u, at(0))
    assert torch.equal(blk[1, :3], 2.0 + 2.0 * torch.stack(
        [at(j)[1] for j in (1, 2, 3)]))
    assert bool((blk[0] == 0.0).all()) and bool((blk[1, 3:] == 0.0).all())
    assert torch.equal(after, at(6))


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    spec = loads.FleetScenarioSpec(n=4)
    for call in (lambda: loads.scenario_bank("idle", [1, 2]),
                 lambda: loads.training_step_bank([1]),
                 lambda: loads.mixed_fleet_bank(4),
                 lambda: loads.mixed_fleet_workloads(4),
                 lambda: spec.workload_set(),
                 lambda: spec.bank(),
                 lambda: list(spec.iter_workload_sets([(0, 4)])),
                 lambda: fe.fleet_audit(4, workload=spec),
                 lambda: stream_fleet(4, workload=spec)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    # the scalar generators build host timelines
    assert loads.scenario_timeline("dvfs", 3).edges.device.type == "cpu"


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shifts,W", [(0, 0.0), (8, 0.025), (3, 0.1)])
@pytest.mark.parametrize("mix", [None, rload.ADVERSARIAL_MIX],
                         ids=["default", "adversarial"])
def test_train_bank_is_the_per_device_trains(mix, shifts, W):
    """The §5 trains of a ragged mixed fleet, built at once, are the
    one-device trains (``meter._train_arrays``, held against the
    reference's by ``test_torch_audit``) stacked, bit for bit."""
    ws = loads.mixed_fleet_workloads(40, mix=mix, seed=3, as_bank=True,
                                     device=CPU)
    rows = np.array([0, 5, 3, 39, 17, 22, 8, 1, 30])
    reps = np.array([32, 33, 5, 1, 40, 8, 9, 16, 2])
    got = pm._train_bank(ws, rows, reps, shifts, W)
    k = got.n_segs
    for g, i in enumerate(rows):
        want_e, want_p = pm._train_arrays(ws.timeline_bank.row(int(i)),
                                          int(reps[g]), shifts, W)
        n = int(k[g])
        assert n == len(want_p)
        assert torch.equal(got.edges[g, :n + 1], want_e)
        assert torch.equal(got.powers[g, :n], want_p)
    assert got.edges.shape[1] == int(k.max()) + 1

@pytest.mark.parametrize("chunk,prefetch", [(None, False), (16, False),
                                            (16, True)])
def test_fleet_audit_over_a_spec_matches_reference(
        monkeypatch, reference_draws, carried, chunk, prefetch):
    """48 devices of every transient kind and a module-scope row on a
    mixed fleet: the fleet's hidden parameters, noise, §5 offsets and
    scenario draws the reference's."""
    _carry_fleet(monkeypatch, reference_draws)
    names = AUDIT * 6
    n = len(names)
    want = rfe.fleet_audit(n, names, workload=rload.FleetScenarioSpec(
        n, seed=5), seed=3, good_practice=True, backend="numpy",
        chunk_devices=chunk)
    got = fe.fleet_audit(n, names, workload=loads.FleetScenarioSpec(
        n, seed=5), seed=3, good_practice=True, chunk_devices=chunk,
        prefetch_workloads=prefetch, device=CPU)
    for key in ("naive_j", "gp_j", "true_j"):
        np.testing.assert_allclose(_np(getattr(got, key)),
                                   getattr(want, key), rtol=E_RTOL,
                                   atol=E_ATOL, err_msg=key)
    for key in ("naive_err", "gp_err"):
        np.testing.assert_allclose(_np(getattr(got, key)),
                                   getattr(want, key), rtol=0, atol=1e-12,
                                   err_msg=key)
    np.testing.assert_array_equal(got.scenarios, want.scenarios)
    for errs in ("naive_err", "gp_err"):
        g = got.by_scenario(getattr(got, errs))
        w = want.by_scenario(getattr(want, errs))
        assert set(g) == set(w) == set(rload.DEFAULT_MIX)
        for label in w:
            for k in w[label]:
                assert g[label][k] == pytest.approx(w[label][k], rel=1e-9,
                                                    abs=1e-12), (label, k)
    for key in ("naive", "good_practice"):
        gs, ws = got.streamed[key], want.streamed[key]
        assert set(gs["by_scenario"]) == set(ws["by_scenario"])
        for label, w in [("overall", ws["overall"])] + sorted(
                ws["by_scenario"].items()):
            g = gs["overall"] if label == "overall" else \
                gs["by_scenario"][label]
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-9, abs=1e-12), \
                    (key, label, k)


def test_fleet_audit_spec_equals_its_workload_set():
    """Slabs synthesised on demand are the whole fleet's rows: the spec
    and its materialised set give the same audit, chunked or not."""
    spec = loads.FleetScenarioSpec(40, mix=rload.ADVERSARIAL_MIX, seed=2)
    whole = fe.fleet_audit(40, "kepler", workload=spec.workload_set(
        device=CPU), seed=1, good_practice=True, device=CPU)
    chunked = fe.fleet_audit(40, "kepler", workload=spec, seed=1,
                             good_practice=True, chunk_devices=15,
                             prefetch_workloads=True, device=CPU)
    np.testing.assert_array_equal(chunked.scenarios, whole.scenarios)
    for key in ("naive_j", "gp_j"):
        torch.testing.assert_close(getattr(chunked, key),
                                   getattr(whole, key), rtol=1e-12, atol=0.0)
    assert torch.equal(chunked.true_j, whole.true_j)


def test_stream_fleet_spec_equals_its_workload_set():
    spec = loads.FleetScenarioSpec(n=12, seed=5)
    ref = stream_fleet(12, profile="a100", workload=spec.workload_set(
        device=CPU), seed=1, device=CPU)
    got = stream_fleet(12, profile="a100", workload=spec, seed=1,
                       chunk_devices=5, device=CPU)
    assert torch.equal(got.naive_stream_j, ref.naive_stream_j)
    assert torch.equal(got.corrected_stream_j, ref.corrected_stream_j)
    assert torch.equal(got.durations_s, ref.durations_s)
    np.testing.assert_array_equal(got.labels, ref.labels)


@pytest.mark.parametrize("chunk", [None, 7])
def test_stream_fleet_over_a_spec_matches_reference(
        monkeypatch, reference_draws, carried, chunk):
    _carry_fleet(monkeypatch, reference_draws)
    names = ["a100"] * 10 + ["v100"] * 5 + ["h100_instant"] * 5
    n = len(names)
    want = rreplay_mod.stream_fleet(
        n, profile=names, workload=rload.FleetScenarioSpec(n, seed=7),
        seed=3, chunk_devices=chunk, compare=True, backend="numpy")
    got = stream_fleet(n, profile=names, workload=loads.FleetScenarioSpec(
        n, seed=7), seed=3, chunk_devices=chunk, compare=True, device=CPU)
    for key in ("naive_stream_j", "corrected_stream_j", "naive_offline_j",
                "corrected_offline_j", "durations_s", "win_a", "win_b"):
        np.testing.assert_allclose(_np(getattr(got, key)),
                                   getattr(want, key), rtol=E_RTOL,
                                   atol=E_ATOL, err_msg=key)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_samples == want.n_samples
    assert got.monitor.counters == want.monitor.counters


def test_size_mismatch_raises_in_both_entry_points():
    spec = loads.FleetScenarioSpec(n=5)
    with pytest.raises(ValueError, match="covers 5 devices, audit asked "
                                         "for 6"):
        fe.fleet_audit(6, profile="a100", workload=spec, device=CPU)
    with pytest.raises(ValueError, match="covers 5 devices, stream asked "
                                         "for 6"):
        stream_fleet(6, profile="a100", workload=spec, device=CPU)
    with pytest.raises(ValueError, match="chunk_devices"):
        fe.fleet_audit(5, profile="a100", workload=spec, chunk_devices=0,
                       device=CPU)
