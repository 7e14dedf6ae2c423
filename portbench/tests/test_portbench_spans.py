"""The program's spans on the trace's clock (``portbench.spans``) and the
per-layer metrics that read them: the alignment, its refusals, each
metric on a hand-built trace, and a traced CPU run of each cell."""
import json

import pytest

from portbench import harness
from portbench import spans as pspans
from portbench.trace import TraceData
from repro_torch.common import spans as rspans

#: trace time less program time, microseconds
OFFSET_US = -1.0e6
INGEST_PHASES = {"prep": 9e-6, "kernel": 2e-6, "fold": 10e-6,
                 "moments": 23e-6}
AUDIT_PHASES = {"bank": 48e-6, "synth_wait": 150e-6, "measure": 70e-6,
                "moments": 290e-6}
N_TRACED = 2_000_000


@pytest.fixture(autouse=True)
def clean_recorder():
    rspans.disable()
    rspans.reset()
    yield
    rspans.reset()


class Builder:
    """Program spans given on the trace's clock (us), stored as the
    recorder stores them (ns on its own clock)."""

    def __init__(self):
        self.spans, self.next = [], 1

    def add(self, name, a, b, parent=None, root=None, thread=1):
        sid = self.next
        self.next += 1
        ns = [round((t - OFFSET_US) * 1e3) for t in (a, b)]
        self.spans.append(rspans.Span(sid, name, parent, root or sid,
                                      thread, *ns))
        return sid


def _ingest_slab(b, at, top="ingest.grid"):
    """One slab at ``at`` us: portbench's span [at, at + 100], the
    program's over the same instants and its four phases."""
    t = b.add(top, at, at + 100)
    for name, lo, hi in (("prep", 1, 30), ("kernel", 30, 40),
                         ("fold", 40, 70), ("moments", 70, 98)):
        pid = b.add(f"ingest.{name}", at + lo, at + hi, t, t)
        if name == "prep":
            b.add("read.ingest.clean", at + 10, at + 20, pid, t)
    ops = [("k", at + 5, at + 25), ("k", at + 32, at + 60),
           ("k", at + 75, at + 80)]
    return (at, at + 100), ops


def _ingest_case(slabs=2):
    b = Builder()
    outer, ops = [], []
    for i in range(slabs):
        o, d = _ingest_slab(b, 200.0 * i)
        outer.append(o)
        ops += d
    trace = TraceData({"ingest": outer, "traffic": []}, ops, [],
                      (0.0, 200.0 * slabs))
    counters = {"ingest.host_reads": 6 * slabs, "ingest.fallbacks": 1}
    return trace, rspans.Recorded(b.spans, counters, 0)


def _audit_case():
    b = Builder()
    t = b.add("audit.run", 0, 1000)
    for name, lo, hi in (("bank", 2, 100), ("synth_wait", 100, 300),
                         ("measure", 300, 700), ("moments", 700, 990)):
        b.add(f"audit.{name}", lo, hi, t, t)
    b.add("read.audit.synth", 160, 170, thread=2)     # the prefetch worker
    ops = [("k", 50, 150), ("k", 320, 650)]
    trace = TraceData({"audit": [(0.0, 1000.0)]}, ops, [], (0.0, 1000.0))
    return trace, rspans.Recorded(b.spans, {"audit.host_reads": 3000}, 0)


def _ctx(trace, info=None):
    return harness.TraceContext(trace, info or {})


def _use(monkeypatch, rec):
    monkeypatch.setattr(pspans, "_recorded", lambda: rec)


def test_alignment_recovers_a_known_offset(monkeypatch):
    trace, rec = _ingest_case(slabs=5)
    # portbench's spans close 1 us after the program's, or later
    trace.spans["ingest"] = [(a, b + 1.0 + 30.0 * (i % 3))
                             for i, (a, b) in enumerate(trace.spans["ingest"])]
    _use(monkeypatch, rec)
    prog = pspans.program(_ctx(trace), "ingest")
    assert prog is not None and prog.units == 5
    assert prog.offset_us == pytest.approx(OFFSET_US + 0.5, abs=1e-6)
    assert prog.residual_us == pytest.approx(0.0, abs=1e-6)
    top = prog.pairs[0][1]
    assert prog.us(top) == pytest.approx((0.5, 100.5), abs=1e-6)


def test_a_call_delayed_on_its_way_in_is_no_residual(monkeypatch):
    """One slab's top span starting 150 us late, another's ending 90 us
    early: their portbench spans still hold them."""
    trace, rec = _ingest_case(slabs=5)
    trace.spans["ingest"][2] = (trace.spans["ingest"][2][0] - 150.0,
                                trace.spans["ingest"][2][1])
    trace.spans["ingest"][3] = (trace.spans["ingest"][3][0],
                                trace.spans["ingest"][3][1] + 90.0)
    _use(monkeypatch, rec)
    prog = pspans.program(_ctx(trace), "ingest")
    assert prog is not None
    assert prog.offset_us == pytest.approx(OFFSET_US, abs=1e-6)
    assert prog.residual_us == pytest.approx(0.0, abs=1e-6)


def test_a_residual_over_the_limit_gives_none(monkeypatch):
    """A clock that jumped 120 us between two slabs: no offset holds every
    top span inside its portbench span, and the best leaves one 60 us out."""
    trace, rec = _ingest_case(slabs=3)
    a, b = trace.spans["ingest"][1]
    trace.spans["ingest"][1] = (a + 120.0, b + 120.0)
    _use(monkeypatch, rec)
    assert pspans.program(_ctx(trace), "ingest") is None
    assert pspans.program(_ctx(trace), "ingest",
                          limit_us=1e3).residual_us == pytest.approx(60.0)
    trace.spans["ingest"][1] = (a + 80.0, b + 80.0)    # 40 us: within
    assert pspans.program(_ctx(trace), "ingest") is not None


def test_a_pair_count_mismatch_gives_none(monkeypatch):
    trace, rec = _ingest_case(slabs=3)
    trace.spans["ingest"] = trace.spans["ingest"][:2]
    _use(monkeypatch, rec)
    assert pspans.program(_ctx(trace), "ingest") is None


def test_dropped_spans_give_none(monkeypatch):
    trace, rec = _ingest_case()
    _use(monkeypatch, rec._replace(dropped=1))
    assert pspans.program(_ctx(trace), "ingest") is None


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    trace, _ = _ingest_case()
    _use(monkeypatch, None)
    for name in ("ingest_core_ms", "ingest_host_reads_per_slab",
                 "ingest_fallback_pct", "ingest_idle_ms.prep"):
        assert harness.reader(name)(_ctx(trace)) is None


def test_the_ingest_metrics_on_a_hand_built_trace(monkeypatch):
    trace, rec = _ingest_case(slabs=2)
    _use(monkeypatch, rec)
    ctx = _ctx(trace)
    assert harness.reader("ingest_core_ms")(ctx) == pytest.approx(0.1)
    assert harness.reader("ingest_host_reads_per_slab")(ctx) == 6.0
    assert harness.reader("ingest_fallback_pct")(ctx) == 50.0
    for phase, sec in INGEST_PHASES.items():
        got = harness.reader(f"ingest_idle_ms.{phase}")(ctx)
        assert got == pytest.approx(1e3 * sec, rel=1e-6), phase
    idle = pspans.program(ctx, "ingest").idle_by_phase(trace.busy())
    assert idle["other"] == pytest.approx(2 * 3e-6)
    assert idle["total"] == pytest.approx(2 * 47e-6)


def test_the_audit_metrics_on_a_hand_built_trace(monkeypatch):
    trace, rec = _audit_case()
    _use(monkeypatch, rec)
    ctx = _ctx(trace, {"devices_traced": N_TRACED})
    assert harness.reader("audit_host_reads_per_1m_dev")(ctx) == 1500.0
    for phase, sec in AUDIT_PHASES.items():
        got = harness.reader(f"audit_idle_s_per_1m_dev.{phase}")(ctx)
        assert got == pytest.approx(sec / N_TRACED * 1e6, rel=1e-6), phase
    idle = pspans.program(ctx, "audit").idle_by_phase(trace.busy())
    assert idle["other"] == pytest.approx(12e-6)


def test_idle_metrics_need_device_operations(monkeypatch):
    trace, rec = _ingest_case()
    trace.device_ops = []
    _use(monkeypatch, rec)
    assert harness.reader("ingest_idle_ms.fold")(_ctx(trace)) is None
    assert harness.reader("ingest_core_ms")(_ctx(trace)) is not None


COUNTED = {
    "fleet100k-1khz.aligned": {"ingest_core_ms", "ingest_host_reads_per_slab",
                               "ingest_fallback_pct"},
    "fleet100k-1khz.shuffled": {"ingest_core_ms",
                                "ingest_host_reads_per_slab"},
    "audit1m-mix.batch": {"audit_host_reads_per_1m_dev"},
}


@pytest.mark.parametrize("workload", sorted(COUNTED))
def test_a_traced_cpu_run_prints_the_program_metrics(small_cell, workload):
    cell = small_cell(workload, trace=True)
    out = harness.driver(cell.config["system"]).run(cell, 0.0)
    line = json.loads(json.dumps(harness.result_line(cell, out)))
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert COUNTED[workload] <= set(got)
    # the CPU has no device operations: no idle to split
    assert not [k for k in got if k.startswith(("ingest_idle_ms.",
                                                "audit_idle_s_per_1m_dev."))]
    if workload.endswith("aligned"):
        assert got["ingest_host_reads_per_slab"] == 6.0
        assert got["ingest_fallback_pct"] == 0.0
    elif workload.endswith("shuffled"):
        assert got["ingest_host_reads_per_slab"] == 18.0
    else:
        assert got["audit_host_reads_per_1m_dev"] > 0.0
