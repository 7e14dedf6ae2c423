"""The hardened monitor (``MonitorService(strict_ids=False,
health=HealthPolicy(), health_every_s=0.5, silent_after_s=1.0)``) on the
benchmark's faulted flat stream, held on the CPU at 64 devices against
the plain reference of ``portbench/reference/monitor_health.py``: each of
the source's faults alone and all of them together, a device that dies,
goes stale, is quarantined and is promoted again when its samples come
back, id rejection on both ingest paths, and the fault generator (fixed
by the seed; any device's samples rebuilt from its decisions alone).
"""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.drivers import monitor_health as driver  # noqa: E402
from portbench.gen.monitor_health import FaultyTraffic  # noqa: E402
from portbench.reference import faults  # noqa: E402
from portbench.reference import monitor_health as reference  # noqa: E402
from repro_torch.core.stream import HealthPolicy, MonitorService  # noqa: E402
from repro_torch.core.stream.health import (HEALTHY,  # noqa: E402
                                            QUARANTINED, STALE)

PB = ROOT / "portbench"
CELL = "fleet100k-1khz-hardened.faulty"
N_DEV = 64
SEED = 2**31 + 29
#: each fault of the source's FaultSpec, by the traffic fields that set it
KINDS = {"duplicate": ("dup_fraction",), "drop": ("drop_fraction",),
         "delay": ("delay_fraction",), "corrupt": ("corrupt_fraction",),
         "clock": ("clock_drift", "clock_skew_s"),
         "restart": ("restart_every_s",), "dropout": ("dropout_fraction",)}
ALL_FAULTS = sum(KINDS.values(), ())


def setting(only=None, **traffic):
    """The cell's configuration at 64 devices and its traffic mix, with
    only the faults ``only`` on (all of them for None)."""
    cfg = json.loads((PB / "configs" / "fleet100k-1khz-hardened.json")
                     .read_text())
    cfg["n_devices"] = N_DEV
    tr = json.loads((PB / "traffic" / "faulty.json").read_text())
    tr["job_cycles"] = 2            # windows inside a short stream
    if only is not None:
        for k in ALL_FAULTS:
            if k not in only:
                tr[k] = 0.0
    tr.update(traffic)
    return cfg, tr


def run(cfg, tr, n_slabs, seed=SEED, each=None):
    """The program's and the reference's outputs after ``n_slabs`` slabs,
    every report accounting for every sample sent; ``each(i, mon)`` after
    each slab."""
    gen = FaultyTraffic(cfg, tr, seed, "cpu")
    mon = driver.build_monitor(cfg, gen, "cpu")
    for i in range(n_slabs):
        dev, t, v = gen.slab(i)
        rep = mon.ingest(dev, t, v)
        assert (rep.accepted + rep.duplicates + rep.late + rep.invalid
                + rep.rejected) == dev.numel()
        if each is not None:
            each(i, mon)
    return driver.program_outputs(mon), reference.expected(gen, n_slabs)


def assert_agree(prog, ref, cfg):
    limits = json.loads((PB / "limits" / f"{CELL}.json").read_text())
    got = driver.checks(prog, ref, int(cfg["ring_slots"]))
    assert set(got) == set(limits)
    bad = {k: v for k, v in got.items() if not v <= limits[k]}
    assert not bad, bad


@pytest.mark.parametrize("only", list(KINDS.values()) + [None],
                         ids=list(KINDS) + ["all"])
def test_each_fault_alone_and_all_together(only):
    cfg, tr = setting(only)
    prog, ref = run(cfg, tr, 24)
    assert_agree(prog, ref, cfg)
    c = ref["counters"]
    if only is None or "dup_fraction" in only:
        assert c["duplicates"] > 0
    if only is None or "corrupt_fraction" in only:
        assert c["invalid"] > 0 and c["rejected"] > 0
    if only is None or "delay_fraction" in only:
        assert c["late"] > 0
    if only is None or "dropout_fraction" in only:
        assert c["n_quarantined"] > 0


def test_a_device_dies_goes_stale_is_quarantined_and_comes_back(
        monkeypatch):
    """Device 5 falls silent at 0.1 s and reports again from 4.2 s: stale
    past 1 s of silence, quarantined past 3 s, healthy at the first
    health step after it returns."""
    init = faults.FaultPlan.__init__

    def outage(self, *args, **kw):
        init(self, *args, **kw)
        self.death_poll[5] = 100
        self.revive_poll[5] = 4200
    monkeypatch.setattr(faults.FaultPlan, "__init__", outage)
    cfg, tr = setting(only=(), warmup_slabs=10)
    codes = []
    prog, ref = run(cfg, tr, 16, each=lambda i, mon: codes.append(
        int(mon.health.code[5])))
    assert_agree(prog, ref, cfg)
    walk = [c for k, c in enumerate(codes) if k == 0 or c != codes[k - 1]]
    assert walk == [HEALTHY, STALE, QUARANTINED, HEALTHY]
    assert int(ref["n_quarantines"][5]) == 1
    assert int(ref["health_code"][5]) == HEALTHY


@pytest.mark.parametrize("path", ["grid", "flat"])
def test_out_of_range_ids_are_rejected_on_both_paths(path):
    n, m = 6, 10
    ts = 0.001 * torch.arange(1, m + 1, dtype=torch.float64)
    vals = 100.0 + torch.arange(n * m, dtype=torch.float64).reshape(n, m)
    bad = torch.tensor([n, n + 3])

    def monitor(strict):
        return MonitorService(n, strict_ids=strict, health=HealthPolicy(),
                              health_every_s=0.5, silent_after_s=1.0,
                              device="cpu")

    def feed(mon, ids, v):
        if path == "grid":
            return mon.ingest_grid(ids, ts, v)
        return mon.ingest(ids.repeat_interleave(m), ts.repeat(len(ids)),
                          v.reshape(-1))

    ids = torch.cat([torch.arange(n), bad])
    v = torch.cat([vals, vals[:2]])
    hardened, clean = monitor(False), monitor(True)
    rep = feed(hardened, ids, v)
    assert rep.rejected == 2 * m and rep.accepted == n * m
    feed(clean, torch.arange(n), vals)
    assert hardened.counters == dict(clean.counters, rejected=2 * m)
    for f in ("energy_j", "last_t", "n_samples", "n_changes"):
        assert torch.equal(getattr(hardened.state, f),
                           getattr(clean.state, f)), f
    with pytest.raises(ValueError):
        feed(monitor(True), ids, v)


def test_the_generator_is_fixed_by_the_seed():
    cfg, tr = setting()
    a, b, c = (FaultyTraffic(cfg, tr, s, "cpu") for s in (SEED, SEED, 7))
    for i in (0, 3, 7, 8, 9, 14):
        for x, y in zip(a.slab(i), b.slab(i)):
            assert torch.equal(x.nan_to_num(-1.0), y.nan_to_num(-1.0))
    assert not torch.equal(a.slab(9)[1].nan_to_num(-1.0),
                           c.slab(9)[1].nan_to_num(-1.0))
    assert torch.equal(a.plan.death_poll, b.plan.death_poll)


@pytest.mark.parametrize("seed", [SEED, 7, 2**40 + 3])
def test_every_seed_restarts_at_the_source_rate(seed):
    """Each pool cycle holds ``round(cycle / restart_every_s)`` restarts,
    each blacking out ``restart_blackout_s`` of polls fleet-wide, on every
    seed (not a count drawn once and repeated every cycle)."""
    cfg, tr = setting()
    plan = FaultyTraffic(cfg, tr, seed, "cpu").plan
    k = round(plan.cycle_s / tr["restart_every_s"])
    assert k >= 1
    polls = k * tr["restart_blackout_s"] / float(cfg["poll_period_s"])
    assert abs(int(plan.black.sum()) - polls) <= k


def _key(dev, t, v):
    rows = zip(dev.tolist(), t.nan_to_num(-1.0).tolist(),
               v.nan_to_num(-1.0, posinf=-2.0).tolist())
    return sorted(rows)


@pytest.mark.parametrize("slab", [3, 9])
def test_any_device_is_rebuilt_from_its_own_decisions(slab):
    """A device's samples in a slab follow from its own draws alone: its
    polls of the slab not held back, then those of the slab before that
    were."""
    cfg, tr = setting()
    gen = FaultyTraffic(cfg, tr, SEED, "cpu")
    plan = gen.plan
    dev, t, v = gen.slab(slab)
    for d in (int(torch.nonzero(plan.dead)[0]), 0, N_DEV - 1):
        mine = (dev == d) | (dev == d + N_DEV)
        rows = torch.tensor([d])
        want = []
        for o, held in ((slab, False), (slab - 1, True)):
            q, c = o % gen.pool_ticks, o // gen.pool_ticks
            f = plan.flags(q, rows)
            sent = plan.alive(o)[d] & ~f["gone"][0]
            kind = f["kind"][0]
            base = plan.skew[d] + (1.0 + plan.drift[d]) * \
                gen.readings.pool_ts[q]
            tt = faults.times(base, plan.step[d].expand_as(base), c)
            tt = torch.where(kind == faults.NAN_TIME, float("nan"), tt)
            vv = gen.readings.pool[q, d].clone()
            vv[kind == faults.NAN_VALUE] = float("nan")
            vv[kind == faults.INF_VALUE] = float("inf")
            ids = torch.where(kind == faults.BAD_ID, d + N_DEV, d)
            for copy, delay in ((sent, f["delay0"][0]),
                                (sent & f["dup"][0], f["delay1"][0])):
                pick = copy & (delay if held else ~delay)
                want += _key(ids[pick], tt[pick], vv[pick])
        assert _key(dev[mine], t[mine], v[mine]) == sorted(want), d
