"""The port's fault bank and ``stream_fleet`` against the JAX package's
numpy tier (``repro.core.stream.replay``).

The same input slabs go through both ``FaultInjector``s: the port draws
the reference's numpy generators on the host and applies them to
tensors, so the faulted slabs, ``log.counts``, ``log.slabs``,
``summary()`` and the held tail must be bitwise the reference's.  A
faulted ``replay`` of a bank whose hidden parameters and reading noise
are carried across from the reference's goes into a port monitor
(``device="cpu"``) and a reference monitor (``backend="numpy"``):
counters and the ``"injected"`` counts bitwise, energies to rtol = atol
= 1e-12 (``test_torch_stream.assert_same_state``).  ``stream_fleet``
with the reference's hidden parameters, noise and workloads: window
energies to rtol 1e-12 plus atol 1e-9 J against the reference,
rtol 1e-11 against the offline ``integrate_polled`` (the reference's
own bar, ``tests/test_stream.py``), chunked against unchunked bitwise.
"""
import dataclasses
import importlib
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_draws  # noqa: E402
from test_resilience import ALL_FAULTS, _slabs  # noqa: E402
from test_torch_audit import (_carry_fleet, _tbank, _tl,  # noqa: E402,F401
                              reference_draws)
from test_torch_stream import _pair, assert_same_state  # noqa: E402

from repro.core import fleet_engine as rfe  # noqa: E402
from repro.core import load as rload  # noqa: E402
from repro.core.meter import Workload as RWorkload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fleet_engine as fe  # noqa: E402
from repro_torch.core import meter as pm  # noqa: E402
from repro_torch.core.stream import (FaultInjector, FaultSpec,  # noqa: E402
                                     InjectionLog, MonitorService,
                                     StreamFleetResult, replay,
                                     stream_fleet)

# the module (``repro.core.stream.replay`` is also the function's name)
rreplay_mod = importlib.import_module("repro.core.stream.replay")
CPU = "cpu"
E_RTOL, E_ATOL = 1e-12, 1e-9
MIXED_NAMES = ["a100"] * 10 + ["v100"] * 5 + ["h100_instant"] * 5
#: one spec per fault alone, the legacy knobs together, and all at once
SPECS = {
    "dropout": FaultSpec(dropout_fraction=0.4, dropout_after=0.3, seed=2),
    "restarts": FaultSpec(restart_every_s=0.4, restart_blackout_s=0.07,
                          seed=3),
    "clock": FaultSpec(clock_drift=0.02, clock_skew_s=0.03, seed=4),
    "corrupt": FaultSpec(corrupt_fraction=0.2, seed=5),
    "legacy": FaultSpec(shuffle=True, dup_fraction=0.2, drop_fraction=0.1,
                        delay_fraction=0.15, seed=6),
    "all": ALL_FAULTS,
}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_slab_equal(got, want, label=""):
    for g, w, name in zip(got, want, ("dev", "ts", "vs")):
        g = _np(g)
        assert g.dtype == w.dtype, f"{label} {name}"
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


def _injectors(spec, n, t0, t1):
    return (rreplay_mod.FaultInjector(spec, n, t0, t1),
            FaultInjector(spec, n, t0, t1, device=CPU))


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

def test_fault_spec_validation():
    with pytest.raises(ValueError, match="dup_fraction"):
        FaultSpec(dup_fraction=1.5)
    with pytest.raises(ValueError, match="clock_drift"):
        FaultSpec(clock_drift=1.0)
    with pytest.raises(ValueError, match="clock_skew_s"):
        FaultSpec(clock_skew_s=-0.1)
    with pytest.raises(ValueError, match="restart"):
        FaultSpec(restart_every_s=-1.0)
    with pytest.raises(ValueError, match="dropout_after"):
        FaultSpec(dropout_after=1.5)
    assert not FaultSpec().any
    assert FaultSpec(corrupt_fraction=0.1).any


def test_fault_spec_fields_and_counts_are_the_references():
    got = [(f.name, f.default) for f in dataclasses.fields(FaultSpec)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(rreplay_mod.FaultSpec)]
    assert got == want
    assert FaultSpec().counts_zero() == rreplay_mod.FaultSpec().counts_zero()
    assert [f.name for f in dataclasses.fields(InjectionLog)] == [
        f.name for f in dataclasses.fields(rreplay_mod.InjectionLog)]
    for name in SPECS:
        spec = SPECS[name]
        assert spec.any == rreplay_mod.FaultSpec(
            **dataclasses.asdict(spec)).any


# ---------------------------------------------------------------------------
# the injector against the reference's
# ---------------------------------------------------------------------------

def test_fault_injector_slab_decisions_are_seq_keyed():
    """Slab ``seq`` injects identical faults whatever came before it."""
    spec = FaultSpec(drop_fraction=0.2, corrupt_fraction=0.2,
                     dup_fraction=0.2, shuffle=True, seed=3)
    slabs = _slabs(6, n_slabs=6, seed=1)
    a = FaultInjector(spec, 6, 0.0, 3.0, device=CPU)
    full = [a.apply(i, *s) for i, s in enumerate(slabs)]
    b = FaultInjector(spec, 6, 0.0, 3.0, device=CPU)
    only3 = b.apply(3, *slabs[3])
    for got, want in zip(only3, full[3]):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_injector_plan_and_log_are_the_references(name):
    """The same slabs through both injectors: every faulted slab, the
    plan, ``counts``, ``slabs``, ``summary()`` and the flushed tail,
    bitwise."""
    spec = SPECS[name]
    n, n_slabs = 7, 9
    ref, port = _injectors(spec, n, 0.0, 0.5 * n_slabs)
    for f in ("drift_rate", "skew_s", "dropout_t", "restarts"):
        np.testing.assert_array_equal(getattr(port.log, f),
                                      getattr(ref.log, f), err_msg=f)
    for seq, slab in enumerate(_slabs(n, n_slabs=n_slabs, seed=11)):
        want = ref.apply(seq, *slab)
        got = port.apply(seq, *slab)
        _assert_slab_equal(got, want, f"{name} slab {seq}")
    _assert_slab_equal(port.flush(), ref.flush(), f"{name} flush")
    assert port.log.counts == ref.log.counts
    assert port.log.slabs == ref.log.slabs
    assert port.log.summary() == ref.log.summary()
    json.dumps(port.log.summary())
    # clock faults move timestamps and count nothing
    assert any(port.log.counts.values()) or name == "clock"


def test_injector_reset_and_empty_flush():
    spec = FaultSpec(delay_fraction=0.5, seed=1)
    inj = FaultInjector(spec, 4, 0.0, 1.0, device=CPU)
    dev, ts, vs = inj.flush()
    assert dev.numel() == ts.numel() == vs.numel() == 0
    assert dev.dtype == torch.int64 and ts.dtype == torch.float64
    inj.apply(0, *_slabs(4, n_slabs=1, seed=2)[0])
    assert inj.log.counts["delayed"] > 0
    inj.reset()
    assert inj.flush()[0].numel() == 0


def test_fault_injector_plan_is_deterministic_and_logged():
    a = FaultInjector(ALL_FAULTS, 8, 0.0, 4.0, device=CPU)
    b = FaultInjector(ALL_FAULTS, 8, 0.0, 4.0, device=CPU)
    for f in ("drift_rate", "skew_s", "dropout_t", "restarts"):
        np.testing.assert_array_equal(getattr(a.log, f), getattr(b.log, f))
    assert np.isfinite(a.log.dropout_t).any()      # someone died
    dead = a.log.dropout_t[np.isfinite(a.log.dropout_t)]
    assert np.all(dead >= 0.0 + 0.4 * 4.0)         # after dropout_after
    s = a.log.summary()
    json.dumps(s)
    assert s["n_devices"] == 8 and s["seed"] == 7


def test_injector_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FaultInjector(ALL_FAULTS, 4, 0.0, 1.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        stream_fleet(4)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _banks(monkeypatch, n, seed=0):
    """The reference's ``test_resilience._bank`` and the port's bank with
    its hidden parameters and reading noise."""
    _torch_draws.substitute(monkeypatch, _torch_draws.reference_bank)
    names = ["a100"] * n
    rb = rfe.SensorBank.from_catalog(names, seeds=np.arange(n) + seed)
    pb = convert.sensor_bank(names, rb.true_gain, rb.true_offset,
                             rb.true_phase, model_gain=rb._model_gain,
                             seed=seed, device=CPU)
    tl = rload.step(0.1, 0.7, 210.0, idle_w=60.0)
    rb.attach(tl, t_end=tl.t_end + 1.0)
    pb.attach(_tl(tl), t_end=tl.t_end + 1.0)
    return rb, pb


def test_replay_signature_is_the_references():
    got = inspect.signature(replay).parameters
    want = inspect.signature(rreplay_mod.replay).parameters
    assert list(got) == list(want)
    for k in want:
        assert got[k].default == want[k].default, k
        assert got[k].kind == want[k].kind, k


@pytest.mark.parametrize("grid", [None, False])
def test_clean_replay_reports_zero_injections(monkeypatch, grid):
    """The repaired result: a clean replay carries ``"injected"``, all
    zero, and ``grid=None`` takes the grid path exactly when clean."""
    rb, pb = _banks(monkeypatch, 5)
    calls = []
    port = MonitorService(5, device=CPU)
    monkeypatch.setattr(port, "ingest_grid", lambda *a: calls.append(1)
                        or MonitorService.ingest_grid(port, *a))
    ref, _ = _pair(5)
    want = rreplay_mod.replay(rb, ref, 0.0, 1.0, grid=grid)
    got = replay(pb, port, 0.0, 1.0, grid=grid)
    assert got["injected"] == FaultSpec().counts_zero()
    assert got == want
    assert bool(calls) == (grid is None)
    assert_same_state(ref, port, f"grid={grid}")


def test_replay_device_base_offsets_the_ids(monkeypatch):
    rb, pb = _banks(monkeypatch, 3)
    ref, port = _pair(8)
    want = rreplay_mod.replay(rb, ref, 0.0, 0.6, device_base=5)
    got = replay(pb, port, 0.0, 0.6, device_base=5)
    assert got == want
    assert torch.equal(port.state.has,
                       torch.arange(8) >= 5)
    assert_same_state(ref, port, "device_base")


def test_replay_faults_and_legacy_knobs_conflict(monkeypatch):
    _, pb = _banks(monkeypatch, 4)
    with pytest.raises(ValueError, match="not both"):
        replay(pb, MonitorService(4, device=CPU), 0.0, 1.0, shuffle=True,
               faults=FaultSpec(shuffle=True))
    with pytest.raises(ValueError, match="grid"):
        replay(pb, MonitorService(4, device=CPU), 0.0, 1.0,
               faults=FaultSpec(drop_fraction=0.1), grid=True)


def test_replay_reports_injection_counts(monkeypatch):
    _, pb = _banks(monkeypatch, 6)
    mon = MonitorService(6, strict_ids=False, device=CPU)
    rep = replay(pb, mon, 0.0, 1.0, faults=ALL_FAULTS)
    inj = rep["injected"]
    assert inj["dropped"] > 0 and inj["duplicated"] > 0
    assert inj["corrupt_value"] + inj["corrupt_id"] + inj["corrupt_time"] > 0
    # duplication can re-emit a corrupted sample, hence >=
    assert rep["rejected"] >= inj["corrupt_id"] > 0


def test_legacy_knobs_equal_explicit_spec(monkeypatch):
    _, pb = _banks(monkeypatch, 5)
    a = MonitorService(5, device=CPU)
    replay(pb, a, 0.0, 1.0, shuffle=True, dup_fraction=0.2,
           drop_fraction=0.1, seed=11)
    b = MonitorService(5, device=CPU)
    replay(pb, b, 0.0, 1.0,
           faults=FaultSpec(shuffle=True, dup_fraction=0.2,
                            drop_fraction=0.1, seed=11))
    assert torch.equal(a.state.energy_j, b.state.energy_j)
    assert torch.equal(a.state.win_corr_j, b.state.win_corr_j)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_faulted_replay_matches_reference(monkeypatch, name):
    """A faulted replay into both monitors: the result dicts (counters
    and ``"injected"``) bitwise, the online state at the 1e-12 bar."""
    rb, pb = _banks(monkeypatch, 6, seed=2)
    ref, port = _pair(6, seed=4, strict_ids=False, max_hold_s=0.4,
                      ring_slots=4)
    for mon in (ref, port):
        mon.set_windows(0.15, 0.85)
    seen = {"ref": [], "port": []}
    want = rreplay_mod.replay(
        rb, ref, 0.0, 1.5, tick_s=0.25, faults=SPECS[name],
        progress=lambda m, t: seen["ref"].append(t))
    got = replay(pb, port, 0.0, 1.5, tick_s=0.25, faults=SPECS[name],
                 progress=lambda m, t: seen["port"].append(t))
    assert got == want
    assert seen["port"] == seen["ref"]
    assert_same_state(ref, port, name)


# ---------------------------------------------------------------------------
# stream_fleet
# ---------------------------------------------------------------------------

def _mixed_workloads(n, seed):
    ws = rload.mixed_fleet_workloads(n, seed=seed, as_bank=True)
    return ws, pm.WorkloadSet(bank=_tbank(ws.timeline_bank),
                              scenarios=list(ws.scenarios))


def _burst():
    tl = rload.multi_phase_workload([(0.130, 215.0), (0.070, 165.0)])
    return RWorkload("burst", tl), pm.Workload("burst", _tl(tl))


@pytest.mark.parametrize("chunk", [None, 7])
@pytest.mark.parametrize("mixed", [False, True])
def test_stream_fleet_matches_reference(monkeypatch, reference_draws, mixed,
                                        chunk):
    """Hidden parameters, reading noise and workloads carried across:
    streamed and offline energies against the reference's."""
    _carry_fleet(monkeypatch, reference_draws)
    if mixed:
        names = MIXED_NAMES
        rwl, pwl = _mixed_workloads(len(names), 7)
    else:
        names = "a100"
        rwl, pwl = _burst()
    n = len(MIXED_NAMES) if mixed else 8
    want = rreplay_mod.stream_fleet(n, profile=names, workload=rwl, seed=3,
                                    chunk_devices=chunk, compare=True,
                                    backend="numpy")
    got = stream_fleet(n, profile=names, workload=pwl, seed=3,
                       chunk_devices=chunk, compare=True, device=CPU)
    assert isinstance(got, StreamFleetResult)
    for key in ("naive_stream_j", "corrected_stream_j", "naive_offline_j",
                "corrected_offline_j", "durations_s", "win_a", "win_b"):
        np.testing.assert_allclose(_np(getattr(got, key)),
                                   getattr(want, key), rtol=E_RTOL,
                                   atol=E_ATOL, err_msg=key)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_samples == want.n_samples
    assert got.monitor.counters == want.monitor.counters


@pytest.mark.parametrize("mixed", [False, True])
def test_stream_matches_offline_integrate_polled(mixed):
    """The stream against the offline integral on the same schedules, at
    the reference's own 1e-11; the §5 corrections move the estimate."""
    if mixed:
        names = MIXED_NAMES
        _, wl = _mixed_workloads(len(names), 7)
    else:
        names = "a100"
        _, wl = _burst()
    n = len(MIXED_NAMES) if mixed else 8
    res = stream_fleet(n, profile=names, workload=wl, seed=0, compare=True,
                       device=CPU)
    torch.testing.assert_close(res.naive_stream_j, res.naive_offline_j,
                               rtol=1e-11, atol=0.0)
    torch.testing.assert_close(res.corrected_stream_j,
                               res.corrected_offline_j, rtol=1e-11,
                               atol=0.0)
    assert float((res.corrected_stream_j
                  - res.naive_stream_j).abs().max()) > 1e-3


def test_stream_chunked_equals_unchunked():
    n = len(MIXED_NAMES)
    _, ws = _mixed_workloads(n, 11)
    whole = stream_fleet(n, profile=MIXED_NAMES, workload=ws, seed=0,
                         device=CPU)
    chunked = stream_fleet(n, profile=MIXED_NAMES, workload=ws, seed=0,
                           chunk_devices=7, device=CPU)
    assert torch.equal(chunked.naive_stream_j, whole.naive_stream_j)
    assert torch.equal(chunked.corrected_stream_j, whole.corrected_stream_j)


def test_stream_matches_fleet_audit_naive():
    """The port's stream against the port's own audit on the same
    fleet, at the reference's 1e-11."""
    n = len(MIXED_NAMES)
    _, ws = _mixed_workloads(n, 7)
    audit = fe.fleet_audit(n, profile=MIXED_NAMES, workload=ws, seed=0,
                           device=CPU)
    res = stream_fleet(n, profile=MIXED_NAMES, workload=ws, seed=0,
                       device=CPU)
    torch.testing.assert_close(res.naive_stream_j, audit.naive_j,
                               rtol=1e-11, atol=0.0)


def test_stream_fleet_module_scope_needs_a_baseline():
    with pytest.raises(pm.ModuleScopeError, match="host_baseline_w"):
        stream_fleet(2, profile=["a100", "gh200_module_instant"],
                     device=CPU)
    with pytest.raises(ValueError, match="profile names"):
        stream_fleet(3, profile=["a100"], device=CPU)


# ---------------------------------------------------------------------------
# on the card: 10a's gates at a small size (chip_smoke.py runs them at
# 100,000 devices)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def test_cuda_faulted_replay_matches_cpu(cuda):
    out = {}
    for where in ("cuda", CPU):
        bank = fe.SensorBank.from_catalog(["a100"] * 40, seed=1,
                                          device=where)
        bank.attach(convert.timeline(*(lambda t: (t.edges, t.powers,
                                                   t.idle_w))(
            rload.step(0.1, 0.7, 210.0, idle_w=60.0))), t_end=2.0)
        mon = MonitorService(40, strict_ids=False, device=where)
        rep = replay(bank, mon, 0.0, 1.5, faults=ALL_FAULTS)
        out[where] = (rep, mon.state.energy_j.cpu())
    assert out["cuda"][0] == out[CPU][0]
    torch.testing.assert_close(out["cuda"][1], out[CPU][1], rtol=1e-12,
                               atol=1e-9)
