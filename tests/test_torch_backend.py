"""The port's engine ops and kernel wrappers against the JAX package's
numpy reference (``repro.core.engine_backend.numpy_backend``).

Same inputs, made with numpy from a seed, go through both.  Floats are
held at rtol = atol = 1e-12 (the reference's own bar for its accelerated
tiers, ``tests/test_backend_parity.py``); counters, run tracking and flags
bitwise.  The CUDA kernels themselves run only on the card: their tests
here skip without one, and ``chip_smoke.py`` holds them against the plain
versions at the main path's shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from test_backend_parity import _ingest_args, _valid_ingest_slab  # noqa: E402

from repro.core.engine_backend import numpy_backend as nb  # noqa: E402
from repro.core.engine_backend.pytrees import (  # noqa: E402
    ReadingSchedule as RSchedule)
from repro.core.ground_truth import TimelineBank as RBank  # noqa: E402
from repro.core import load as loads  # noqa: E402
from repro_torch.engine_backend import torch_backend as tb  # noqa: E402
from repro_torch.engine_backend.pytrees import (  # noqa: E402
    ReadingSchedule, TimelineArrays)
from repro_torch.kernels import stream_ingest as k_flat  # noqa: E402
from repro_torch.kernels import stream_ingest_grid as k_grid  # noqa: E402

RTOL = ATOL = 1e-12
# the reference's flat output layout (numpy_backend.stream_ingest); its
# grid layout is the port's IngestGridOut
REF_FLAT = ("new_t", "new_v", "new_run_t", "new_n_changes", "counts",
            "d_energy", "d_energy_corr", "d_win", "d_win_corr", "sum_vc",
            "n_out", "cum_e", "cum_ec", "vc", "run_dur", "run_rec")


def _t(x, device="cpu"):
    return torch.as_tensor(np.asarray(x), device=device)


def _to_torch(args, device="cpu"):
    return [a if isinstance(a, bool) else _t(a, device) for a in args]


def _ref_flat(fn, args):
    """The reference tier ``fn``'s flat outputs by name, plus the reading
    moments the port's ``stream_ingest`` adds, reduced with numpy from
    the reference's own ``vc``."""
    out = dict(zip(REF_FLAT, fn(*args)))
    seg, u = np.asarray(args[2]), len(args[6])
    av = np.abs(np.asarray(out["vc"]))
    out["sum_vc2"] = np.bincount(seg, weights=av * av, minlength=u)
    out["sum_abs_vc"] = np.bincount(seg, weights=av, minlength=u)
    out["max_abs_vc"] = np.zeros(u)
    np.maximum.at(out["max_abs_vc"], seg, av)
    return out


def _ref_grid(fn, args):
    return dict(zip(tb.IngestGridOut._fields, fn(*args)))


def assert_outputs(ref, got, label, atol=ATOL):
    """``got`` (an IngestOut or IngestGridOut) against ``ref`` (a mapping
    by field name, or an output tuple of the same kind): the fields in
    ``BITWISE`` and integer outputs exactly, the other floats to rtol
    1e-12 and ``atol``."""
    ref = ref._asdict() if hasattr(ref, "_asdict") else ref
    assert set(ref) == set(got._fields), label
    for name in got._fields:
        a = ref[name]
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = getattr(got, name).cpu().numpy()
        assert a.shape == b.shape, f"{label}: {name} shape"
        if name in got.BITWISE or a.dtype != np.float64:
            np.testing.assert_array_equal(b.astype(a.dtype), a,
                                          err_msg=f"{label}: {name}")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=atol,
                                       err_msg=f"{label}: {name}")


def _grid_args(rng, d, m, trapezoid):
    ts = np.cumsum(rng.uniform(1e-4, 0.1, m)) + 2.0
    v = rng.uniform(60.0, 250.0, (d, m))
    rep = rng.random((d, m)) < 0.4
    v[rep] = np.round(v[rep] / 25.0) * 25.0
    has_prev = rng.random(d) > 0.3
    prev_t = rng.uniform(0.0, 2.0, d)
    win_a = rng.uniform(1.5, 3.0, d)
    win_b = np.where(rng.random(d) < 0.2, win_a,
                     win_a + rng.uniform(0.0, 2.0, d))
    return (ts, v, prev_t, rng.uniform(60.0, 250.0, d), has_prev,
            np.where(has_prev, prev_t, ts[0] if m else 0.0),
            rng.integers(0, 4, d), rng.uniform(0.95, 1.05, d),
            rng.uniform(-3.0, 3.0, d), rng.uniform(0.0, 0.05, d), win_a,
            win_b, np.where(rng.random(d) < 0.5, np.inf, 0.05),
            np.where(rng.random(d) < 0.5, -np.inf, 70.0),
            np.where(rng.random(d) < 0.5, np.inf, 240.0), trapezoid)


# ---------------------------------------------------------------------------
# query-side and source-side ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("broadcast", [False, True])
def test_searchsorted_rows_on_inf_padded_rows(side, broadcast):
    rng = np.random.default_rng(1)
    r, s, m = (1 if broadcast else 6), 9, 13
    a = np.sort(np.round(rng.uniform(0, 5, (r, s)), 1), axis=1)
    for i in range(r):                 # inf padding, some rows all-inf
        a[i, rng.integers(0, s + 1):] = np.inf
    v = np.round(rng.uniform(-1, 6, (6, m)), 1)
    v[:, :3] = a[0, :3] if np.isfinite(a[0, :3]).all() else 1.0  # ties
    v[0, -1] = np.inf
    got = tb.searchsorted_rows(_t(a), _t(v), side)
    np.testing.assert_array_equal(got.numpy(),
                                  nb.searchsorted_rows(a, v, side))


def test_searchsorted_rows_rejects_bad_side_and_shapes():
    with pytest.raises(ValueError):
        tb.searchsorted_rows(torch.zeros(1, 3), torch.zeros(1, 2), "up")
    with pytest.raises(ValueError):
        tb.searchsorted_rows(torch.zeros(2, 3), torch.zeros(3, 2))


def _random_bank(rng, g):
    tls = [loads.square_wave(float(rng.uniform(0.05, 0.4)),
                             int(rng.integers(1, 8)),
                             float(rng.uniform(150, 250)),
                             float(rng.uniform(60, 120)),
                             seed=int(rng.integers(0, 1000)))
           for _ in range(g)]
    ra = RBank.from_timelines(tls).arrays
    ta = TimelineArrays(*(_t(x) for x in ra))
    return ra, ta


@pytest.mark.parametrize("g", [1, 5])
def test_cum_energy_timeline_integral_and_boxcar_means(g):
    rng = np.random.default_rng(g)
    ra, ta = _random_bank(rng, g)
    np.testing.assert_allclose(tb.cum_energy(ta).numpy(), nb.cum_energy(ra),
                               rtol=RTOL, atol=ATOL)
    rows = 5                            # a 1-row bank broadcasts
    t1 = rng.uniform(-1.0, 5.0, (rows, 17))
    t0 = t1 - rng.choice([0.0, 0.025, 0.1, 1.0], (rows, 17))
    np.testing.assert_allclose(
        tb.timeline_integral(ta, _t(t0), _t(t1)).numpy(),
        nb.timeline_integral(ra, t0, t1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tb.boxcar_means(ta, _t(t0), _t(t1)).numpy(),
        nb.boxcar_means(ra, t0, t1), rtol=RTOL, atol=ATOL)


def _schedule(rng, n, m):
    T = rng.choice([0.02, 0.1, 1.0], n)
    phase = rng.uniform(0.0, 1.0, n) * T
    k0 = np.floor((0.0 - phase) / T).astype(np.int64)
    ks = k0[:, None] + np.arange(m)[None, :]
    ticks = phase[:, None] + T[:, None] * ks
    first = rng.integers(0, 2, n)
    last = m - 1 - rng.integers(0, 2, n)
    return RSchedule(ticks, first, last, k0, phase, T)


def test_query_slots_settles_at_tick_boundaries():
    rng = np.random.default_rng(7)
    rs = _schedule(rng, 8, 40)
    ts = ReadingSchedule(*(_t(x) for x in rs))
    # exact tick instants, their neighbours one ulp away, and far outside
    tq = np.concatenate([rs.ticks[:, ::3],
                         np.nextafter(rs.ticks[:, 1::5], -np.inf),
                         np.nextafter(rs.ticks[:, 2::5], np.inf),
                         rng.uniform(-2.0, 50.0, (8, 20))], axis=1)
    np.testing.assert_array_equal(tb.query_slots(ts, _t(tq)).numpy(),
                                  nb.query_slots(rs, tq))


@pytest.mark.parametrize("ring", [False, True])
def test_snapshot_energy_at_matches_reference(ring):
    rng = np.random.default_rng(11 + ring)
    n, r = 9, 4
    last_t = rng.uniform(1.0, 2.0, n)
    has = rng.random(n) > 0.2
    first_t = last_t - rng.uniform(0.0, 1.0, n)
    args = [last_t, rng.uniform(50, 250, n), has, first_t,
            rng.uniform(0, 300, n), np.where(rng.random(n) < 0.5, np.inf,
                                             0.3)]
    if ring:
        ring_t = np.sort(rng.uniform(0.5, 2.0, (n, r)), axis=1)
        ring_t[0, 2:] = np.inf           # unused slots
        rings = [ring_t, rng.uniform(50, 250, (n, r)),
                 rng.uniform(0, 300, (n, r))]
    else:
        rings = [None, None, None]
    tq = np.concatenate([rng.uniform(0.0, 3.0, 12), first_t[:2], last_t[:2]])
    e_ref, c_ref = nb.snapshot_energy_at(tq, *args, *rings)
    e, c = tb.snapshot_energy_at(_t(tq), *(_t(a) for a in args),
                                 *(None if x is None else _t(x)
                                   for x in rings))
    np.testing.assert_array_equal(c.numpy(), c_ref)
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=RTOL, atol=ATOL,
                               equal_nan=True)


def test_err_moments_matches_reference():
    e = np.random.default_rng(3).normal(0.0, 5.0, 101)
    ref = nb.err_moments(e)
    got = tb.err_moments(_t(e))
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1:], ref[1:], rtol=RTOL, atol=ATOL)
    assert tb.err_moments(torch.zeros(0, dtype=torch.float64)) == \
        nb.err_moments(np.zeros(0))


# ---------------------------------------------------------------------------
# the plain versions of the two kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("trapezoid", [False, True])
def test_plain_stream_ingest_matches_reference(seed, trapezoid):
    rng = np.random.default_rng(seed)
    slab = _valid_ingest_slab(rng, int(rng.integers(1, 300)),
                              int(rng.integers(1, 9)),
                              single_sample=(seed == 0))
    args = _ingest_args(slab, trapezoid)
    assert_outputs(_ref_flat(nb.stream_ingest, args),
                   tb.stream_ingest(*_to_torch(args)), f"seed={seed}")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("trapezoid", [False, True])
def test_plain_stream_ingest_grid_matches_reference(seed, trapezoid):
    rng = np.random.default_rng(100 + seed)
    d, m = int(rng.integers(1, 25)), int(rng.integers(1, 60))
    args = _grid_args(rng, d, m, trapezoid)
    assert_outputs(_ref_grid(nb.stream_ingest_grid, args),
                   tb.stream_ingest_grid(*_to_torch(args)), f"seed={seed}")


def test_plain_stream_ingest_grid_empty_slab_passes_state_through():
    rng = np.random.default_rng(0)
    args = _grid_args(rng, 3, 0, False)
    assert_outputs(_ref_grid(nb.stream_ingest_grid, args),
                   tb.stream_ingest_grid(*_to_torch(args)), "empty")


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), k=st.integers(1, 200),
       u=st.integers(1, 10), trapezoid=st.booleans())
def test_property_plain_stream_ingest(seed, k, u, trapezoid):
    rng = np.random.default_rng(seed)
    args = _ingest_args(_valid_ingest_slab(rng, k, u), trapezoid)
    assert_outputs(_ref_flat(nb.stream_ingest, args),
                   tb.stream_ingest(*_to_torch(args)), f"seed={seed}")


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), d=st.integers(1, 24),
       m=st.integers(1, 40), trapezoid=st.booleans())
def test_property_plain_stream_ingest_grid(seed, d, m, trapezoid):
    rng = np.random.default_rng(seed)
    args = _grid_args(rng, d, m, trapezoid)
    assert_outputs(_ref_grid(nb.stream_ingest_grid, args),
                   tb.stream_ingest_grid(*_to_torch(args)), f"seed={seed}")


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------
def test_wrappers_run_the_plain_version_on_cpu_tensors_uncounted():
    rng = np.random.default_rng(5)
    flat = _to_torch(_ingest_args(_valid_ingest_slab(rng, 50, 4), True))
    grid = _to_torch(_grid_args(rng, 5, 9, False))
    n0, g0 = k_flat.stream_ingest.launches, k_grid.stream_ingest_grid.launches
    for a, b in zip(k_flat.stream_ingest(*flat), tb.stream_ingest(*flat)):
        assert torch.equal(a, b)
    for a, b in zip(k_grid.stream_ingest_grid(*grid),
                    tb.stream_ingest_grid(*grid)):
        assert torch.equal(a, b)
    assert k_flat.stream_ingest.launches == n0
    assert k_grid.stream_ingest_grid.launches == g0


def test_pallas_tier_in_interpret_mode():
    """The JAX package's Pallas kernels against the port's plain versions,
    where the installed jax can load that tier at all."""
    try:
        from repro.core.engine_backend import pallas_backend as pb
    except Exception as exc:        # the tier's own import error
        pytest.skip(f"the pallas tier does not import here: {exc!r}")
    rng = np.random.default_rng(9)
    args = _ingest_args(_valid_ingest_slab(rng, 120, 5), False)
    assert_outputs(_ref_flat(pb.stream_ingest, args),
                   tb.stream_ingest(*_to_torch(args)), "pallas flat")
    gargs = _grid_args(rng, 6, 20, False)
    assert_outputs(_ref_grid(pb.stream_ingest_grid, gargs),
                   tb.stream_ingest_grid(*_to_torch(gargs)), "pallas grid")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def _energy_atol(t, pt, v, pv, gain, offset):
    """The tolerance for energies: 1e-12 × the slab's Σ|increment| (the
    kernel sums each device alone, the plain version re-bases a
    slab-wide prefix).  Σ|increment| is bounded from above by
    Σ (|v| + |pv| + |offset|) / |gain| · |t - pt|."""
    dens = (np.abs(v) + np.abs(pv) + np.abs(offset)) / np.abs(gain)
    return 1e-12 * max(float(np.sum(dens * np.abs(t - pt))), 1.0)


def _flat_atol(args):
    t, v, seg, first, _, _, prev_t, prev_v = args[:8]
    pt = np.where(first, prev_t[seg], np.r_[0.0, t[:-1]])
    pv = np.where(first, prev_v[seg], np.r_[0.0, v[:-1]])
    return _energy_atol(t, pt, v, pv, args[11][seg], args[12][seg])


def _grid_atol(args):
    ts, v, prev_t, prev_v = args[:4]
    d, m = v.shape
    if m == 0:
        return ATOL
    pt = np.concatenate([prev_t[:, None],
                         np.broadcast_to(ts[:-1], (d, m - 1))], axis=1)
    pv = np.concatenate([prev_v[:, None], v[:, :-1]], axis=1)
    return _energy_atol(ts[None, :], pt, v, pv, args[7][:, None],
                        args[8][:, None])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("trapezoid", [False, True])
def test_cuda_stream_ingest_kernel_matches_plain(cuda, seed, trapezoid):
    rng = np.random.default_rng(seed)
    args = _ingest_args(_valid_ingest_slab(rng, int(rng.integers(1, 3000)),
                                           int(rng.integers(1, 40)),
                                           single_sample=(seed == 0)),
                        trapezoid)
    assert_outputs(tb.stream_ingest(*_to_torch(args)),
                   k_flat.stream_ingest(*_to_torch(args, cuda)),
                   f"seed={seed}", atol=_flat_atol(args))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("trapezoid", [False, True])
def test_cuda_stream_ingest_grid_kernel_matches_plain(cuda, seed, trapezoid):
    rng = np.random.default_rng(100 + seed)
    args = _grid_args(rng, int(rng.integers(1, 300)),
                      int(rng.integers(0, 700)), trapezoid)
    assert_outputs(tb.stream_ingest_grid(*_to_torch(args)),
                   k_grid.stream_ingest_grid(*_to_torch(args, cuda)),
                   f"seed={seed}", atol=_grid_atol(args))
