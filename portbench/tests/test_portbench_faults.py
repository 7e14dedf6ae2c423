"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a test's size.  The faults a one-chip cell can have: a step
that leaves the state unchanged, half of the batch left out, and an
answer altered where it is produced.  (No cell spans chips, so none can
leave out an exchange between them.)"""
import dataclasses

import pytest
import torch

from portbench import harness

MONITOR = ("fleet100k-1khz.aligned", "fleet100k-1khz.shuffled")


def run_line(cell, fault=None):
    out = harness.driver(cell.config["system"]).run(cell, 0.0, fault=fault)
    return harness.result_line(cell, out)


@pytest.mark.parametrize("workload", MONITOR + ("audit1m-mix.batch",))
def test_sound_run_is_correct(small_cell, workload):
    assert run_line(small_cell(workload))["correct"] is True


# -- the monitor ---------------------------------------------------------------
def unchanged(entry, mon):
    """Each slab is acknowledged and dropped: the state stays as it was."""
    from repro_torch.core.stream import IngestReport

    def call(dev, t, v):
        return IngestReport(v.numel(), 0, 0, 0, dev.numel())
    return call


def half(entry, mon):
    """Only the first half of each slab's samples (grid: of its devices)
    goes in."""
    def call(dev, t, v):
        k = dev.numel() // 2
        if v.ndim == 2:
            rep = entry(dev[:k], t, v[:k])
        else:
            rep = entry(dev[:k], t[:k], v[:k])
        return dataclasses.replace(rep, accepted=rep.accepted * 2)
    return call


@pytest.mark.parametrize("workload", MONITOR)
@pytest.mark.parametrize("fault", [unchanged, half],
                         ids=["state_unchanged", "half_batch"])
def test_monitor_fault_is_caught(small_cell, workload, fault):
    assert run_line(small_cell(workload), fault)["correct"] is False


@pytest.mark.parametrize("workload", MONITOR)
def test_monitor_answer_altered_is_caught(small_cell, workload,
                                          monkeypatch):
    """One device's energy increment, one part in a thousand off, where
    the ingest kernel produces it."""
    import repro_torch.core.stream.ingest as ingest
    name = ("stream_ingest" if workload.endswith("shuffled")
            else "stream_ingest_grid")
    kernel = getattr(ingest, name)

    def altered(*args, **kw):
        out = kernel(*args, **kw)
        out.d_energy[0] *= 1.0 + 1e-3
        return out
    monkeypatch.setattr(ingest, name, altered)
    assert run_line(small_cell(workload))["correct"] is False


# -- the audit -----------------------------------------------------------------
def stale(audit):
    """Every audit answers for the set-up's seed: the window's audits
    hand back an old fleet's results."""
    seen = []

    def call(*args, **kw):
        seen.append(kw["seed"])
        kw["workload"] = dataclasses.replace(kw["workload"], seed=seen[0])
        return audit(*args, **dict(kw, seed=seen[0]))
    return call


def half_fleet(audit):
    """Only the first half of the fleet is audited; its answers stand in
    for the second half too."""
    def call(n, names, **kw):
        spec = kw["workload"]
        kw["workload"] = dataclasses.replace(spec, n=n // 2)
        res = audit(n // 2, names[: n // 2], **kw)
        for key in ("true_j", "naive_j", "naive_err", "gp_j", "gp_err"):
            x = getattr(res, key)
            setattr(res, key, torch.cat([x, x[: n - n // 2]]))
        return res
    return call


@pytest.mark.parametrize("fault", [stale, half_fleet],
                         ids=["state_unchanged", "half_batch"])
def test_audit_fault_is_caught(small_cell, fault):
    cell = small_cell("audit1m-mix.batch")
    assert run_line(cell, fault)["correct"] is False


def test_audit_answer_altered_is_caught(small_cell, monkeypatch):
    """The §5 estimate one part in a thousand off where the protocol
    produces it."""
    import repro_torch.core.fleet_engine as fe
    protocol = fe.measure_good_practice_batch

    def altered(*args, **kw):
        est = protocol(*args, **kw)
        est.joules_per_rep = est.joules_per_rep * (1.0 + 1e-3)
        return est
    monkeypatch.setattr(fe, "measure_good_practice_batch", altered)
    assert run_line(small_cell("audit1m-mix.batch"))["correct"] is False
