"""The generators: fixed by the seed, and readings with the properties
the configuration states."""
import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers.audit import sample_rows
from portbench.gen.monitor import MonitorTraffic
from portbench.reference.audit import (AuditReference, fleet_names,
                                      mix_labels)

from conftest import SMALL_MONITOR


def traffic(layout, seed):
    cfg = dict(harness.read_json(
        harness.PKG / "configs" / "fleet100k-1khz.json"), **SMALL_MONITOR)
    tr = harness.read_json(harness.PKG / "traffic" / (
        "aligned.json" if layout == "grid" else "shuffled.json"))
    return MonitorTraffic(cfg, tr, seed, "cpu")


@pytest.mark.parametrize("layout", ["grid", "flat"])
def test_monitor_traffic_is_fixed_by_the_seed(layout):
    a, b, c = (traffic(layout, s) for s in (2**31 + 3, 2**31 + 3, 5))
    for i in (0, 1, 6):
        for x, y in zip(a.slab(i), b.slab(i)):
            assert torch.equal(x, y)
    assert torch.equal(a.win_a, b.win_a) and torch.equal(a.win_b, b.win_b)
    assert not torch.equal(a.pool, c.pool)
    if layout == "flat":
        assert torch.equal(a.dup_counts, b.dup_counts)
        assert not torch.equal(a.slab(0)[0], c.slab(0)[0])


def test_readings_hold_quantise_and_follow_the_fleet_scenarios():
    g = traffic("grid", 11)
    cfg = g.config
    v = torch.cat(list(g.pool), dim=1)                # [D, cycle]
    ts = torch.cat(list(g.pool_ts))
    q = v / 0.01
    assert torch.allclose(q, torch.round(q), atol=1e-6)
    assert float(v.min()) >= 0.0
    # a held value changes only at the device's own update instants
    ref = AuditReference(cfg, torch.float64, "cpu")
    sens = ref.fleet(g.seed, np.arange(g.n))
    slot = torch.floor((ts[None, :] - sens["phase"][:, None])
                       / sens["period"][:, None])
    change = torch.zeros_like(v, dtype=torch.bool)
    change[:, 1:] = v[:, 1:] != v[:, :-1]
    new_slot = torch.zeros_like(change)
    new_slot[:, 1:] = slot[:, 1:] != slot[:, :-1]
    assert not bool((change & ~new_slot).any())
    assert bool(change.any())
    # the fleet's rows: its profiles, and its scenarios from the seed
    assert g.names == fleet_names(cfg, g.n)
    assert g.labels == [str(x) for x in
                        mix_labels(g.n, cfg["scenario_mix"], g.seed)]
    # a workload's span is its job window's, in one of the first cycles
    span = g.win_b - g.win_a
    assert bool((span > 0.1).all()) and float(span.max()) <= 0.45 + 1e-12
    cyc = (g.win_a - cfg["start_offset_s"]) / g.cycle_s
    assert torch.allclose(cyc, torch.round(cyc), atol=1e-9)
    assert 0 <= float(cyc.min()) and float(cyc.max()) < 2000


def test_the_cycle_repeats_the_sensor_without_a_seam():
    """Across the cycle's end a held value changes only where the
    sensor publishes, as within the cycle."""
    g = traffic("grid", 5)
    v = torch.cat(list(g.pool), dim=1)
    seam = v[:, 0] != v[:, -1]
    ref = AuditReference(g.config, torch.float64, "cpu")
    sens = ref.fleet(g.seed, np.arange(g.n))
    t0 = float(g.pool_ts[0, 0])
    slot_first = torch.floor((t0 - sens["phase"]) / sens["period"])
    slot_prev = torch.floor((t0 - 0.001 - sens["phase"]) / sens["period"])
    assert not bool((seam & (slot_first == slot_prev)).any())


def test_stream_times_advance_by_whole_cycles():
    g = traffic("grid", 1)
    ts = torch.cat([g.times(i) for i in range(3 * g.pool_ticks)])
    assert bool((torch.diff(ts) > 0).all())
    assert float(g.times(g.pool_ticks)[0]) == g.cycle_s
    _, _, vv = g.slab(g.pool_ticks + 1)
    assert torch.equal(vv, g.pool[1])


def test_audit_sample_is_fixed_by_the_seed():
    a = sample_rows(2**31 + 9, 3, 1_000_000, 1024)
    assert np.array_equal(a, sample_rows(2**31 + 9, 3, 1_000_000, 1024))
    assert not np.array_equal(a, sample_rows(2**31 + 9, 4, 1_000_000, 1024))
    assert len(np.unique(a)) == 1024 and a.max() < 1_000_000
