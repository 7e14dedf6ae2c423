"""The hardened monitor's cell on the CPU at 64 devices (its own
configuration override; ``small_cell`` sizes only the ``monitor`` and
audit systems): a sound run is correct, its traced line carries the new
per-layer metrics, and a run with the timed path broken underneath is
not: the state left unchanged, half of each slab, an answer altered, the
health step skipped, late samples accepted.  The control (the reference
in float32) is not correct either."""
import dataclasses

import pytest

from portbench import control_health, harness

CELL = "fleet100k-1khz-hardened.faulty"
SEED = 2**31 + 41


@pytest.fixture(autouse=True)
def clean_recorder():
    from repro_torch.common import spans
    spans.reset()
    yield
    spans.reset()


def cell(trace=False, seconds=1.0):
    c = harness.find_cell(harness.benchmark(), CELL, seed=SEED,
                          seconds=seconds, trace=trace, device="cpu",
                          overrides={"n_devices": 64})
    c.traffic.update(trace_slabs=4, job_cycles=2)
    return c


def run_line(c, fault=None):
    out = harness.driver(c.config["system"]).run(c, 0.0, fault=fault)
    return harness.result_line(c, out)


def test_sound_run_is_correct_and_accounts_for_every_sample():
    line = run_line(cell())
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == set(harness.limits(cell()))


def test_traced_line_carries_the_new_metrics():
    line = run_line(cell(trace=True))
    assert line["correct"] is True
    m = line["metrics"]
    assert m["ingest_health_ms"]["value"] > 0
    assert 5.0 < m["ingest_dropped_pct"]["value"] < 25.0
    assert m["ingest_dropped_pct"]["unit"] == "%"
    # the card's idle under a phase needs device operations: none on CPU
    assert "ingest_idle_ms.health" not in m


def unchanged(entry, mon):
    """Each slab is acknowledged and dropped: the state stays as it was."""
    from repro_torch.core.stream import IngestReport

    def call(dev, t, v):
        return IngestReport(v.numel(), 0, 0, 0, 0)
    return call


def half(entry, mon):
    """Only the first half of each slab goes in; the report claims all."""
    def call(dev, t, v):
        k = dev.numel() // 2
        rep = entry(dev[:k], t[:k], v[:k])
        return dataclasses.replace(rep, accepted=rep.accepted + dev.numel()
                                   - k)
    return call


@pytest.mark.parametrize("fault", [unchanged, half],
                         ids=["state_unchanged", "half_batch"])
def test_broken_entry_is_caught(fault):
    assert run_line(cell(), fault)["correct"] is False


def test_answer_altered_is_caught(monkeypatch):
    """One device's energy increment, one part in a thousand off, where
    the ingest kernel produces it."""
    import repro_torch.core.stream.ingest as ingest
    kernel = ingest.stream_ingest

    def altered(*args, **kw):
        out = kernel(*args, **kw)
        out.d_energy[0] *= 1.0 + 1e-3
        return out
    monkeypatch.setattr(ingest, "stream_ingest", altered)
    assert run_line(cell())["correct"] is False


def test_health_step_skipped_is_caught(monkeypatch):
    from repro_torch.core.stream.ingest import IngestCore
    monkeypatch.setattr(IngestCore, "_maybe_update_health",
                        lambda self, t_now: None)
    line = run_line(cell())
    assert line["correct"] is False
    assert line["checks"]["state_mismatches"]["value"] > 0


def test_late_samples_accepted_is_caught(monkeypatch):
    """The prep forgets each device's newest accepted time, so a sample
    held back a slab is taken in instead of dropped as late."""
    import repro_torch.core.stream.ingest as ingest
    group = ingest.stream_group

    def forgetful(dev, t, v, has, *args, **kw):
        return group(dev, t, v, has.new_zeros(has.shape), *args, **kw)
    monkeypatch.setattr(ingest, "stream_group", forgetful)
    line = run_line(cell())
    assert line["correct"] is False
    assert line["checks"]["state_mismatches"]["value"] > 0


def test_control_is_not_correct():
    c = cell()
    vals = control_health.control(c, SEED + 1, 40)
    limits = harness.limits(c)
    assert set(vals) == set(limits)
    assert not harness.passed({k: (v, float(limits[k]))
                               for k, v in vals.items()})
