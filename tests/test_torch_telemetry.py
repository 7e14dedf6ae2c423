"""The port's energy accounting against the JAX package's numpy tier:
``EnergyLedger`` (``repro.core.ledger``), ``FleetLedger``,
``FleetSummary`` and ``datacenter_projection``
(``repro.core.telemetry``).

The ledger is plain Python and JSON: its text must be the reference's,
crossing both ways.  ``FleetLedger`` sums its batches where they live (a
tensor on the CPU here, or numpy) in PyTorch's order, the reference in
numpy's pairwise order: summaries within 1e-12 relative.  The monitor's
registration runs on the port's CPU monitor and the reference's numpy
monitor after the same ingest.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_serving import _slabs  # noqa: E402
from test_torch_stream import _pair  # noqa: E402

from repro.core import ledger as rledger  # noqa: E402
from repro.core import telemetry as rtel  # noqa: E402
from repro.core.calibrate import CalibrationRecord as RRecord  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.core import ledger as pledger  # noqa: E402
from repro_torch.core import telemetry as ptel  # noqa: E402
from repro_torch.core.calibrate import CalibrationRecord  # noqa: E402

REL = 1e-12


def _ledgers(mod, dev="d0", steps=10, j=50.0):
    led = mod.EnergyLedger(device_id=dev)
    for i in range(steps):
        led.append(i, i * 1.0, (i + 1) * 1.0, j * 1.1, j, 0.05 * j)
    return led


def _random_ledger(mod, seed, dev):
    rng = np.random.default_rng(seed)
    led = mod.EnergyLedger(device_id=dev)
    t = 0.0
    for i in range(int(rng.integers(1, 30))):
        d = float(rng.uniform(0.01, 3.0))
        c = float(rng.uniform(1.0, 500.0))
        led.append(i, t, t + d, c * float(rng.uniform(0.8, 1.3)), c,
                   0.05 * c)
        t += d
    return led


def assert_summary_close(got, want, label=""):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert set(g) == set(w), label
    assert g["n_devices"] == w["n_devices"], label
    for k in w:
        assert g[k] == pytest.approx(w[k], rel=REL, abs=0.0), (label, k)


def assert_by_label_close(got, want):
    assert list(got) == list(want)
    for label in want:
        assert_summary_close(got[label], want[label], label)


# ---------------------------------------------------------------------------
# EnergyLedger
# ---------------------------------------------------------------------------

def test_ledger_fields_are_the_references():
    for p, r in ((pledger.LedgerEntry, rledger.LedgerEntry),
                 (pledger.EnergyLedger, rledger.EnergyLedger)):
        assert ([f.name for f in dataclasses.fields(p)]
                == [f.name for f in dataclasses.fields(r)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_json_crosses_both_ways(seed):
    port = _random_ledger(pledger, seed, f"dev{seed}")
    ref = _random_ledger(rledger, seed, f"dev{seed}")
    assert port.to_json() == ref.to_json()
    back = pledger.EnergyLedger.from_json(ref.to_json())
    assert back == port and back.to_json() == ref.to_json()
    there = rledger.EnergyLedger.from_json(port.to_json())
    assert there.to_json() == port.to_json()
    assert port.summary() == ref.summary()
    assert back.summary() == there.summary()


def test_empty_ledger_crosses_and_summarises():
    port, ref = pledger.EnergyLedger(), rledger.EnergyLedger()
    assert port.to_json() == ref.to_json()
    assert port.summary() == ref.summary()
    assert pledger.EnergyLedger.from_json(ref.to_json()).entries == []


@pytest.mark.parametrize("drift", ["unknown_field", "missing_field"])
def test_ledger_schema_drift_fails_as_the_reference(drift):
    """The reference's ``from_json`` builds each entry from its fields as
    stored; an unknown field or a missing one raises ``TypeError`` in
    both packages."""
    d = json.loads(_ledgers(rledger).to_json())
    if drift == "unknown_field":
        d["entries"][3]["retired_field"] = 1.0
    else:
        del d["entries"][3]["sigma_j"]
    text = json.dumps(d)
    with pytest.raises(TypeError) as want:
        rledger.EnergyLedger.from_json(text)
    with pytest.raises(TypeError) as got:
        pledger.EnergyLedger.from_json(text)
    assert str(got.value) == str(want.value)


def test_ledger_summary_is_the_references():
    port, ref = _ledgers(pledger), _ledgers(rledger)
    assert port.summary() == ref.summary()
    s = port.summary()
    assert s["total_corrected_j"] == pytest.approx(500.0)
    assert s["mean_power_w"] == pytest.approx(50.0)
    assert s["naive_vs_corrected"] == pytest.approx(0.1)
    assert port.entries[0].duration_s == ref.entries[0].duration_s


# ---------------------------------------------------------------------------
# FleetLedger
# ---------------------------------------------------------------------------

def _fill(mod, as_tensor, seed=0):
    """The same registrations into a ledger of either package: object
    ledgers (one calibrated), and labelled, unlabelled, calibrated and
    explicit-sigma batches over different durations."""
    rng = np.random.default_rng(seed)
    led = mod.FleetLedger(price_usd_per_kwh=0.27)
    rec = RRecord if mod is rtel else CalibrationRecord
    for i in range(5):
        calib = (rec(f"d{i}", "a100", 0.1, 0.025, "instant", 0.25,
                     gain=0.97, sampled_fraction=0.25) if i == 2 else None)
        led.register(_random_ledger(rledger if mod is rtel else pledger,
                                    seed + i, f"d{i}"), calib)
    cast = (lambda x: torch.as_tensor(x)) if as_tensor else (lambda x: x)
    kinds = np.array(["training", "inference", "idle", "diurnal"],
                     dtype=object)
    for b in range(4):
        n = int(rng.integers(50, 400))
        e = rng.uniform(1.0, 300.0, n)
        labels = kinds[rng.integers(0, 4, n)] if b != 1 else None
        if b == 2:
            led.register_batch(cast(e), duration_s=float(rng.uniform(1, 9)),
                               calibrated=True, labels=labels)
        elif b == 3:
            led.register_batch(cast(e), sigmas_j=cast(0.02 * e),
                               duration_s=0.0, labels="night")
        else:
            led.register_batch(cast(e), duration_s=float(rng.uniform(1, 9)),
                               labels=labels)
    return led


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_ledger_matches_reference(as_tensor, seed):
    got = _fill(ptel, as_tensor, seed)
    want = _fill(rtel, False, seed)
    assert_summary_close(got.summary(), want.summary())
    assert_by_label_close(got.by_label(), want.by_label())
    by = got.by_label()
    assert "(unlabelled)" in by and "night" in by
    assert sum(s.total_j for s in by.values()) == pytest.approx(
        sum(float(np.sum(b[0])) for b in want._batches), rel=REL)


def test_fleet_ledger_batch_on_a_tensor_sums_where_it_lives():
    e = torch.linspace(1.0, 100.0, 1000, dtype=torch.float64)
    led = ptel.FleetLedger()
    led.register_batch(e, duration_s=2.0, labels=np.where(
        np.arange(1000) % 3 == 0, "a", "b").astype(object))
    stored = led._batches[0]
    assert stored[0].device == e.device and stored[0].dtype == torch.float64
    assert stored[1].dtype == torch.float64
    ref = rtel.FleetLedger()
    ref.register_batch(e.numpy(), duration_s=2.0, labels=np.where(
        np.arange(1000) % 3 == 0, "a", "b").astype(object))
    assert_summary_close(led.summary(), ref.summary())
    assert_by_label_close(led.by_label(), ref.by_label())


def test_empty_ledger_summary_is_all_zero():
    s = ptel.FleetLedger().summary()
    assert s == ptel.FleetSummary(0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    assert dataclasses.asdict(s) == dataclasses.asdict(
        rtel.FleetLedger().summary())
    assert ptel.FleetLedger().by_label() == {}


def test_zero_duration_batches_contribute_no_power():
    led = ptel.FleetLedger()
    led.register_batch(torch.tensor([100.0], dtype=torch.float64))
    s = led.summary()
    assert s.total_j == pytest.approx(100.0)
    assert s.mean_power_w == 0.0


def test_fleet_uncertainty_scaling():
    """Independent ±5 % errors shrink relatively as 1/√N; the correlated
    bound does not."""
    fleet = ptel.FleetLedger()
    n = 64
    for i in range(n):
        fleet.register(_ledgers(pledger, f"d{i}"))
    s = fleet.summary()
    per_dev = 0.05 * 500.0
    assert s.sigma_independent_j == pytest.approx(per_dev * np.sqrt(n),
                                                  rel=1e-12)
    assert s.sigma_worstcase_j == pytest.approx(per_dev * n, rel=1e-12)


def test_calibrated_devices_tighten_fleet_sigma():
    fleet = ptel.FleetLedger()
    calib = CalibrationRecord("d0", "a100", 0.1, 0.025, "instant", 0.25,
                              gain=0.97, offset_w=1.0, sampled_fraction=0.25)
    fleet.register(_ledgers(pledger, "d0"), calib)
    fleet.register(_ledgers(pledger, "d1"))
    assert fleet.summary().sigma_worstcase_j == pytest.approx(
        0.01 * 500.0 + 0.05 * 500.0, rel=1e-12)


def test_mean_power_weights_per_group_durations():
    """100 J over 10 s plus 100 J over 100 s is an 11 W fleet; with an
    object ledger of 100 J over 5 s beside, 31 W."""
    fleet = ptel.FleetLedger(price_usd_per_kwh=1.0)
    fleet.register_batch(np.array([100.0]), duration_s=10.0)
    fleet.register_batch(torch.tensor([100.0], dtype=torch.float64),
                         duration_s=100.0)
    s = fleet.summary()
    assert s.mean_power_w == pytest.approx(11.0)
    expected = (s.sigma_worstcase_j / s.total_j) * 11.0 * 8760.0 / 1000.0
    assert s.annual_cost_uncertainty_usd == pytest.approx(expected)
    led = pledger.EnergyLedger(device_id="d0")
    led.append(0, 0.0, 5.0, 110.0, 100.0, 5.0)
    fleet.register(led)
    assert fleet.summary().mean_power_w == pytest.approx(31.0)


# ---------------------------------------------------------------------------
# the monitor's registration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [None, 2.3])
def test_register_monitor_matches_reference(t):
    """A labelled 30-device monitor with seeded corrections (half of them
    calibrated), fed the same messy slabs; a few devices never report."""
    n = 30
    labels = np.array(["train", "serve", "idle"], dtype=object)[
        np.arange(n) % 3]
    ref, port = _pair(n, seed=4, labels=labels)
    for dev, ts, vs in _slabs(n, n_slabs=6, seed=2):
        keep = dev < n - 3
        ref.ingest(dev[keep], ts[keep], vs[keep])
        port.ingest(dev[keep], ts[keep], vs[keep])
    want, got = rtel.FleetLedger(), ptel.FleetLedger()
    for corrected in (True, False):
        want.register_monitor(ref, t=t, corrected=corrected)
        got.register_monitor(port, t=t, corrected=corrected)
    np.testing.assert_allclose(got._batches[0][0].numpy(),
                               want._batches[0][0], rtol=REL, atol=1e-9)
    assert got._batches[0][2] == want._batches[0][2]
    assert_summary_close(got.summary(), want.summary())
    assert_by_label_close(got.by_label(), want.by_label())


def test_register_monitor_of_a_silent_monitor():
    ref, port = _pair(3)
    want, got = rtel.FleetLedger(), ptel.FleetLedger()
    want.register_monitor(ref)
    got.register_monitor(port)
    assert got._batches[0][2] == want._batches[0][2] == 0.0
    assert_summary_close(got.summary(), want.summary())


def test_register_monitor_two_labels():
    ref, port = _pair(2, labels=np.array(["a", "b"], dtype=object))
    for mon in (ref, port):
        mon.ingest([0, 0, 1, 1], [0.0, 2.0, 0.0, 2.0],
                   [100.0, 100.0, 50.0, 50.0])
    led = ptel.FleetLedger()
    led.register_monitor(port)
    s = led.summary()
    assert s.n_devices == 2 and s.total_j == pytest.approx(300.0)
    by = led.by_label()
    assert by["a"].total_j == pytest.approx(200.0)
    assert by["b"].total_j == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# the projection and the exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(n_gpus=1_000_000, tdp_w=1000.0),
                                dict(gain_tol=0.01, duty=0.5,
                                     price_usd_per_kwh=0.1)])
def test_datacenter_projection_is_the_references(kw):
    assert ptel.datacenter_projection(**kw) == rtel.datacenter_projection(
        **kw)


def test_tolerances_and_exports_are_the_references():
    assert ptel.SHUNT_TOLERANCE == rtel.SHUNT_TOLERANCE
    assert ptel.CALIBRATED_TOLERANCE == rtel.CALIBRATED_TOLERANCE
    assert ([f.name for f in dataclasses.fields(ptel.FleetSummary)]
            == [f.name for f in dataclasses.fields(rtel.FleetSummary)])
    for name in ("EnergyLedger", "LedgerEntry", "FleetLedger",
                 "FleetSummary", "datacenter_projection"):
        assert name in core.__all__ and hasattr(core, name)
