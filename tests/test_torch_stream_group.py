"""``stream_group``: a flat slab grouped by device.

On the CPU the plain version (the monitor's prep as it was: two stable
sorts, masks and gathers) is held against ``np.lexsort`` written out here.
On the card the kernels are held against the plain version bit for bit:
every output tensor (floats as their bits, so -0.0 is not +0.0), every
count and the drop counters they add into the state.  The card tests skip
without CUDA.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import spans  # noqa: E402
from repro_torch.kernels import stream_group as ksg  # noqa: E402

F64, I64 = torch.float64, torch.int64
WIDE = 1024         # the register route's largest bucket (the source's)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# slabs
# ---------------------------------------------------------------------------
def _state(rng, n, has_share=0.5, t_hi=1.0):
    """has, last_t, n_dup, n_late, baseline_w for n devices."""
    has = rng.random(n) < has_share
    last_t = np.where(has, np.round(rng.uniform(0.0, t_hi, n), 3), 0.0)
    return (has, last_t, rng.integers(0, 5, n), rng.integers(0, 5, n),
            np.round(rng.uniform(-3.0, 3.0, n), 2))


def _case(name):
    """(dev, t, v, has, last_t, n_dup, n_late, baseline_w, strict)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 8
    z = np.zeros(n, dtype=bool), np.zeros(n), np.zeros(n, np.int64), \
        np.zeros(n, np.int64), np.zeros(n)
    if name == "duplicates_both_orders":
        dev = np.array([1, 0, 0, 1, 0, 1, 2, 2, 2, 0])
        t = np.array([0.2, 0.1, 0.1, 0.2, 0.3, 0.1, 0.5, 0.5, 0.5, 0.1])
        v = np.arange(10.0) + 100.0
        return (dev, t, v, *z, True)
    if name == "repeat_of_stored_newest":
        has, last_t, nd, nl, base = z
        has = has | (np.arange(n) < 4)
        last_t = np.where(has, 0.25, 0.0)
        dev = np.repeat(np.arange(6), 3)
        t = np.tile([0.25, 0.3, 0.25], 6)
        return (dev, t, 50.0 + np.arange(18.0), has, last_t, nd, nl, base,
                True)
    if name == "late":
        has, last_t, nd, nl, base = _state(rng, n, has_share=1.0)
        dev = rng.integers(0, n, 200)
        t = np.round(rng.uniform(0.0, 1.5, 200), 3)
        return (dev, t, rng.uniform(40, 300, 200), has, last_t, nd, nl,
                base, True)
    if name == "signed_zero":
        has, last_t, nd, nl, base = z
        has = has | (np.arange(n) >= 6)        # devices 6, 7: newest 0.0
        dev = np.array([0, 0, 1, 1, 2, 2, 2, 6, 7, 3, 3])
        t = np.array([-0.0, 0.0, 0.0, -0.0, -0.0, -1e-300, 1e-300, -0.0,
                      0.0, -0.0, -0.0])
        last_t = np.where(np.arange(n) == 6, 0.0, -0.0)
        return (dev, t, 10.0 + np.arange(11.0), has, last_t, nd, nl, base,
                True)
    if name == "nonfinite":
        has, last_t, nd, nl, base = _state(rng, n)
        dev = rng.integers(0, n, 300)
        t = np.round(rng.uniform(0.0, 2.0, 300), 2)
        v = rng.uniform(40, 300, 300)
        t[rng.random(300) < 0.05] = np.inf
        t[rng.random(300) < 0.05] = -np.inf
        t[rng.random(300) < 0.05] = np.nan
        v[rng.random(300) < 0.05] = np.nan
        v[rng.random(300) < 0.05] = -np.inf
        return (dev, t, v, has, last_t, nd, nl, base, True)
    if name == "out_of_range_ids":
        has, last_t, nd, nl, base = _state(rng, n)
        dev = rng.integers(-3, n + 3, 400)
        t = np.round(rng.uniform(0.0, 2.0, 400), 2)
        v = rng.uniform(40, 300, 400)
        v[::17] = np.nan
        return (dev, t, v, has, last_t, nd, nl, base, False)
    if name == "only_out_of_range":
        return (np.array([-1, 8, 9]), np.ones(3), np.ones(3), *z, False)
    if name == "empty":
        return (np.zeros(0, np.int64), np.zeros(0), np.zeros(0), *z, True)
    if name == "all_dropped":
        has, last_t, nd, nl, base = z
        has = ~has
        last_t = last_t + 5.0
        dev = rng.integers(0, n, 100)
        t = np.where(rng.random(100) < 0.5, 5.0,
                     np.round(rng.uniform(0, 5, 100), 2))
        return (dev, t, np.ones(100), has, last_t, nd, nl, base, True)
    if name == "all_invalid":
        return (np.arange(4), np.full(4, np.nan), np.ones(4), *z, True)
    if name == "every_route":
        # buckets at each register route's edges and past them
        sizes = [1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                 511, 512, 513, 1023, 1024, 1025, 2048, 3000, 0, 7]
        n = len(sizes)
        has, last_t, nd, nl, base = _state(rng, n, t_hi=0.3)
        dev = np.repeat(np.arange(n), sizes)
        t = np.round(rng.uniform(0.0, 2.0, dev.size), 3)   # ties
        t[rng.random(dev.size) < 0.01] *= -1.0
        perm = rng.permutation(dev.size)
        return (dev[perm], t[perm], rng.uniform(40, 300, dev.size), has,
                last_t, nd, nl, base, True)
    if name.startswith("one_wide_device"):
        m = int(name.rsplit("_", 1)[1])
        has, last_t, nd, nl, base = _state(rng, n, has_share=1.0, t_hi=0.1)
        dev = np.concatenate([np.full(m, 3), rng.integers(0, n, 500)])
        t = np.round(rng.uniform(0.0, 1.0, dev.size), 4)
        perm = rng.permutation(dev.size)
        return (dev[perm], t[perm], rng.uniform(40, 300, dev.size), has,
                last_t, nd, nl, base, True)
    if name == "one_sample_each_100k":
        n = 100_000
        has, last_t, nd, nl, base = _state(rng, n)
        dev = rng.permutation(n)
        t = np.round(rng.uniform(0.0, 2.0, n), 3)
        return (dev, t, rng.uniform(40, 300, n), has, last_t, nd, nl, base,
                True)
    if name == "shuffled_cell_shape":
        # the shuffled cell's slab at 2,000 devices: 500 ticks a device
        # after a first slab, 1% of the samples sent twice, any order
        n, m = 2000, 500
        has = np.ones(n, dtype=bool)
        last_t = np.full(n, 0.5)
        nd, nl = rng.integers(0, 5, n), rng.integers(0, 5, n)
        base = np.round(rng.uniform(-3.0, 3.0, n), 2)
        dev = np.repeat(np.arange(n), m)
        t = np.tile(0.501 + 0.001 * np.arange(m), n)
        v = rng.uniform(60, 250, n * m)
        pick = rng.integers(0, n * m, n * m // 100)
        dev, t, v = (np.concatenate([x, x[pick]]) for x in (dev, t, v))
        perm = rng.permutation(dev.size)
        return (dev[perm], t[perm], v[perm], has, last_t, nd, nl, base, True)
    raise KeyError(name)


CASES = ["duplicates_both_orders", "repeat_of_stored_newest", "late",
         "signed_zero", "nonfinite", "out_of_range_ids", "only_out_of_range",
         "empty", "all_dropped", "all_invalid", "every_route",
         "one_wide_device_5000", "one_wide_device_70000",
         "one_sample_each_100k", "shuffled_cell_shape"]


def _tensors(case, device):
    dev, t, v, has, last_t, nd, nl, base, strict = case
    f = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt,  # noqa: E731
                                      device=device)
    return (f(dev, I64), f(t, F64), f(v, F64), f(has, torch.bool),
            f(last_t, F64), f(nd, I64), f(nl, I64), f(base, F64)), strict


# ---------------------------------------------------------------------------
# np.lexsort written out: the reference's order
# ---------------------------------------------------------------------------
def _lexsort_group(dev, t, v, has, last_t, n_dup, n_late, base, strict):
    n = has.shape[0]
    ok = (dev >= 0) & (dev < n)
    if strict and not ok.all():
        raise ValueError("device id out of range")
    rej = int((~ok).sum())
    dev, t, v = dev[ok], t[ok], v[ok]
    fin = np.isfinite(t) & np.isfinite(v)
    inv = int((~fin).sum())
    dev, t, v = dev[fin], t[fin], v[fin]
    order = np.lexsort((t, dev))
    dev, t, v = dev[order], t[order], v[order]
    dup = np.r_[False, (dev[1:] == dev[:-1]) & (t[1:] == t[:-1])]
    late = ~dup & has[dev] & (t < last_t[dev])
    dropped = dup | (~dup & has[dev] & (t == last_t[dev]))
    n_dup, n_late = n_dup.copy(), n_late.copy()
    np.add.at(n_dup, dev[dropped], 1)
    np.add.at(n_late, dev[late], 1)
    keep = ~(dropped | late)
    dev, t, v = dev[keep], t[keep], v[keep] - base[dev[keep]]
    first = np.r_[True, dev[1:] != dev[:-1]] if dev.size else \
        np.zeros(0, bool)
    start = np.flatnonzero(first)
    end = np.r_[start[1:] - 1, dev.size - 1] if dev.size else start
    return dict(dev=dev, t=t, v=v, seg=np.cumsum(first) - 1, first=first,
                start_idx=start, end_idx=end, u_dev=dev[start],
                rejected=rej, invalid=inv, duplicates=int(dropped.sum()),
                late=int(late.sum()), n_dup=n_dup, n_late=n_late)


def _bits(x):
    x = x.detach().cpu()
    return x.view(torch.int64) if x.dtype == F64 else x


def _assert_same(got, want, label):
    """Two Groupeds bit for bit (only counts where nothing is kept)."""
    for f in ("rejected", "in_range", "invalid", "duplicates", "late"):
        assert getattr(got, f) == getattr(want, f), f"{label}: {f}"
    k = want.dev.numel()
    for f in ksg.Grouped._fields[:8]:
        a, b = getattr(got, f), getattr(want, f)
        if k == 0:
            assert a.numel() == 0, f"{label}: {f}"
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f"{label}: {f}"
        assert torch.equal(_bits(a), _bits(b)), f"{label}: {f}"


@pytest.mark.parametrize("name", CASES)
def test_plain_grouping_is_np_lexsorts(name):
    """The plain version keeps, orders, baselines and counts as the
    reference's np.lexsort and masks do, bit for bit."""
    case = _case(name)
    args, strict = _tensors(case, "cpu")
    nd, nl = args[5], args[6]
    want = _lexsort_group(*[np.asarray(x) for x in case[:8]], strict)
    got = ksg.stream_group(*args, strict_ids=strict)
    assert isinstance(got, ksg.Grouped)
    for f in ("rejected", "invalid", "duplicates", "late"):
        assert getattr(got, f) == want[f], f
    for f in ksg.Grouped._fields[:8]:
        a = getattr(got, f).numpy()
        if want["dev"].size == 0:
            assert a.size == 0, f
            continue
        b = np.asarray(want[f])
        assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind, f
        np.testing.assert_array_equal(a.view(np.int64) if a.dtype == np.float64
                                      else a,
                                      b.view(np.int64) if b.dtype == np.float64
                                      else b, err_msg=f)
    np.testing.assert_array_equal(nd.numpy(), want["n_dup"])
    np.testing.assert_array_equal(nl.numpy(), want["n_late"])


def test_plain_grouping_raises_on_ids_out_of_range_and_changes_nothing():
    case = list(_case("out_of_range_ids"))
    args, _ = _tensors(case, "cpu")
    before = [x.clone() for x in args[5:7]]
    with pytest.raises(ValueError, match="device id out of range"):
        ksg.stream_group(*args, strict_ids=True)
    assert all(torch.equal(a, b) for a, b in zip(args[5:7], before))


def test_stream_group_refuses_other_devices():
    meta = torch.device("meta")
    args, _ = _tensors(_case("late"), meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ksg.stream_group(*args)


# ---------------------------------------------------------------------------
# on the card: the kernels against the plain version
# ---------------------------------------------------------------------------
def _card_vs_plain(args, strict, dev, in_place=False):
    """Run both on copies of the same inputs and state (the kernels on
    ``args`` themselves with ``in_place``); compare."""
    cpu = [x.detach().cpu().clone() for x in args]
    card = list(args) if in_place else [x.detach().to(dev).clone()
                                        for x in args]
    want = ksg.stream_group(*cpu, strict_ids=strict)
    got = ksg.stream_group(*card, strict_ids=strict)
    torch.cuda.synchronize(dev)
    _assert_same(got, want, "card vs plain")
    for i in (5, 6):
        assert torch.equal(card[i].cpu(), cpu[i]), ("n_dup", "n_late")[i - 5]
    return got


@pytest.mark.parametrize("name", CASES)
def test_cuda_stream_group_matches_plain(cuda, name):
    case = _case(name)
    args, strict = _tensors(case, "cpu")
    spans.reset()
    spans.enable()
    try:
        _card_vs_plain(args, strict, cuda)
        wide = spans.recorded().counters.get("ingest.group_wide", 0)
    finally:
        spans.disable()
        spans.reset()
    dev, t, v, n = case[0], case[1], case[2], len(case[3])
    valid = (dev >= 0) & (dev < n) & np.isfinite(t) & np.isfinite(v)
    sizes = np.bincount(dev[valid], minlength=n)
    assert wide == int(np.sum(sizes > WIDE))
    if name.startswith("one_wide_device"):
        assert wide > 0


def test_wide_threshold_is_the_sources():
    from repro_torch.kernels import _build
    src = (_build.CSRC / _build.SOURCES["stream_group"]).read_text()
    assert f"constexpr int kWarpSortMax = {WIDE};" in src


def test_cuda_stream_group_raises_on_ids_out_of_range(cuda):
    args, _ = _tensors(_case("out_of_range_ids"), cuda)
    before = [x.clone() for x in args[5:7]]
    with pytest.raises(ValueError, match="device id out of range"):
        ksg.stream_group(*args, strict_ids=True)
    assert all(torch.equal(a, b) for a, b in zip(args[5:7], before))


def test_cuda_stream_group_counts_three_launches_a_slab(cuda):
    args, strict = _tensors(_case("late"), cuda)
    ksg.stream_group.launches = 0
    ksg.stream_group(*args, strict_ids=strict)
    assert ksg.stream_group.launches == 3


def test_cuda_monitor_slabs_in_a_row_group_as_the_plain_version(
        cuda, monkeypatch):
    """Several slabs through the monitor on the card, ``has``/``last_t``
    and the counters carried from slab to slab: every call of the kernels
    is checked against the plain version on the same inputs and state."""
    from repro_torch.core.stream import MonitorService
    from repro_torch.core.stream import ingest as ingest_mod

    calls = []

    def checked(*args):
        if args[0].device.type == "cpu":         # the CPU monitor's
            return ksg.stream_group(*args)
        calls.append(1)
        return _card_vs_plain(args[:8], args[8], cuda, in_place=True)

    monkeypatch.setattr(ingest_mod, "stream_group", checked)
    rng = np.random.default_rng(5)
    n = 300
    mons = [MonitorService(n, device=d, ring_slots=4, strict_ids=False)
            for d in (cuda, "cpu")]
    for s in range(5):
        k = 4000
        dev = rng.integers(-2, n + 2, k)
        t = np.round(s * 0.5 + rng.uniform(-0.3, 0.5, k), 3)
        v = rng.uniform(40.0, 300.0, k)
        v[rng.random(k) < 0.02] = np.nan
        reps = [m.ingest(dev, t, v) for m in mons]
        assert reps[0] == reps[1]
    assert len(calls) == 5
    a, b = (m.state for m in mons)
    for f in ("has", "last_t", "first_t", "n_samples", "n_dup", "n_late"):
        assert torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f))), f
    assert mons[0].counters == mons[1].counters
