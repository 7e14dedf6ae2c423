"""The port's ``log_filter`` (the Kepler/Maxwell sensor filter) against the
JAX package's numpy reference, and the CUDA kernel against its plain
version.

Same inputs, made with numpy from a seed, go through both.  The plain
version keeps the reference's step formula and order, so it is held at
rtol = atol = 1e-12 (the reference's own bar for its accelerated tiers).
The CUDA kernel runs only on the card: its tests skip here, and against
the plain version it is held at rtol 1e-12 plus atol 1e-9 W, because
CUDA's ``exp`` and glibc's may differ by an ulp.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_engine_backend import _per_device_timelines  # noqa: E402

from repro.core import load as loads  # noqa: E402
from repro.core.engine_backend import numpy_backend as nb  # noqa: E402
from repro.core.ground_truth import TimelineBank as RBank  # noqa: E402
from repro_torch.engine_backend import torch_backend as tb  # noqa: E402
from repro_torch.engine_backend.pytrees import TimelineArrays  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import log_filter as k_log  # noqa: E402

RTOL = ATOL = 1e-12
KERNEL_RTOL, KERNEL_ATOL = 1e-12, 1e-9


def _port(arrays, device="cpu"):
    return TimelineArrays(*(torch.as_tensor(np.asarray(x), device=device)
                            for x in arrays))


def _square_wave_case(seed):
    """The cases of the reference's log-filter property test: random
    square waves, sorted ticks from before the first edge to past the
    last."""
    rng = np.random.default_rng(seed)
    g = int(rng.integers(1, 9))
    tls = [loads.square_wave(float(rng.uniform(0.05, 0.4)),
                             int(rng.integers(1, 10)),
                             float(rng.uniform(150, 250)),
                             float(rng.uniform(60, 120)),
                             seed=int(rng.integers(0, 1000)))
           for _ in range(g)]
    ticks = np.sort(rng.uniform(-0.5, 4.0, (g, int(rng.integers(1, 21)))),
                    axis=1)
    return RBank.from_timelines(tls).arrays, ticks, rng.uniform(0.05, 1.0, g)


def _per_device_case():
    """The reference's per-device kernel-parity case: four rows of
    different lengths, so the shorter rows carry zero-width padding."""
    tls = RBank.from_timelines(_per_device_timelines(4, seed=9))
    rng = np.random.default_rng(2)
    ticks = np.sort(rng.uniform(0.0, 3.0, size=(4, 25)), axis=1)
    return tls.arrays, ticks, rng.uniform(0.2, 1.0, size=4)


def _adversarial_case(shared, seed=0):
    """Unsorted ticks before the first edge, on edges and past the last;
    per-device rows of very different lengths (zero-width padding), or
    one shared row for G ticks rows."""
    rng = np.random.default_rng(seed)
    tls = [loads.square_wave(0.23, 16, 220.0, 90.0),
           loads.multi_phase_workload([(0.13, 215.0), (0.07, 165.0)]),
           loads.square_wave(0.05, 2, 250.0, 60.0).shift(1.5)]
    arrays = RBank.from_timelines(tls[:1] if shared else tls).arrays
    g = 5 if shared else 3
    ticks = rng.uniform(-2.0, 6.0, (g, 40))
    ticks[:, :3] = arrays.edges[:, :3] if not shared else arrays.edges[0, :3]
    ticks[:, 3] = -50.0
    ticks[:, 4] = 40.0
    return arrays, ticks, rng.uniform(0.01, 1.5, g)


CASES = ([("square_wave", s) for s in range(6)]
         + [("per_device", 0), ("padded_rows", 0), ("shared_row", 0)])


def _case(kind, seed):
    if kind == "square_wave":
        return _square_wave_case(seed)
    if kind == "per_device":
        return _per_device_case()
    return _adversarial_case(kind == "shared_row", seed)


@pytest.mark.parametrize("kind, seed", CASES)
def test_plain_log_filter_matches_numpy_reference(kind, seed):
    arrays, ticks, tau = _case(kind, seed)
    ref = nb.log_filter(arrays, ticks, tau)
    got = tb.log_filter(_port(arrays), torch.as_tensor(ticks),
                        torch.as_tensor(tau))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_plain_log_filter_state_before_first_edge_is_idle():
    """Ticks before every edge read exactly idle_w, whatever the span."""
    arrays, _, tau = _adversarial_case(False)
    ticks = np.array([[-3.0, -1e-3]] * 3)
    got = tb.log_filter(_port(arrays), torch.as_tensor(ticks),
                        torch.as_tensor(tau))
    np.testing.assert_array_equal(
        got.numpy(), np.broadcast_to(arrays.idle_w[:, None], (3, 2)))


@pytest.mark.parametrize("kind, seed", CASES)
def test_plain_log_filter_does_not_depend_on_the_span(kind, seed,
                                                      monkeypatch):
    """Bitwise the same readings under a wider padding span: the state
    entering the first edge is idle whatever t_lo, a tick before it reads
    idle, and the state after t_hi is never read.  So the CUDA kernel
    takes no span."""
    arrays, ticks, tau = _case(kind, seed)
    args = (_port(arrays), torch.as_tensor(ticks), torch.as_tensor(tau))
    want = tb.log_filter(*args)
    span = tb.log_filter_span

    def wider(tl, ticks, tau):
        lo, hi = span(tl, ticks, tau)
        return torch.stack([lo - 7.0, hi + 3.0])

    monkeypatch.setattr(tb, "log_filter_span", wider)
    assert torch.equal(tb.log_filter(*args), want)


def test_log_filter_span_is_the_reference_padding():
    arrays, ticks, tau = _adversarial_case(False)
    span = tb.log_filter_span(_port(arrays), torch.as_tensor(ticks),
                              torch.as_tensor(tau)).tolist()
    t_lo = (min(float(np.min(ticks)), float(np.min(arrays.edges[:, 0])))
            - 5.0 * float(np.max(tau)))
    t_hi = max(float(np.max(ticks)), float(np.max(arrays.edges[:, -1])))
    assert span == [t_lo, t_hi + 1e-9]


def test_wrapper_runs_the_plain_version_on_the_cpu_without_launching():
    arrays, ticks, tau = _per_device_case()
    n0 = k_log.log_filter.launches
    got = k_log.log_filter(_port(arrays), torch.as_tensor(ticks),
                           torch.as_tensor(tau))
    assert torch.equal(got, tb.log_filter(_port(arrays),
                                          torch.as_tensor(ticks),
                                          torch.as_tensor(tau)))
    assert k_log.log_filter.launches == n0


def test_wrapper_never_runs_the_plain_version_off_the_cpu():
    meta = dict(dtype=torch.float64, device=torch.device("meta"))
    tl = TimelineArrays(torch.zeros((1, 3), **meta), torch.zeros((1, 2), **meta),
                        torch.zeros(1, **meta),
                        torch.zeros(1, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        k_log.log_filter(tl, torch.zeros((2, 4), **meta),
                         torch.zeros(2, **meta))


def test_kernel_argument_struct_ends_with_states_and_out():
    """The wrapper passes ``inputs + [states, out]`` as one pointer array
    (``states`` null on the shared-memory route), in the source struct's
    field order; no span."""
    src = (_build.CSRC / _build.SOURCES["log_filter"]).read_text()
    body = re.search(r"struct LogFilterArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\*\s*(\w+);", body)
    assert fields == ["edges", "powers", "idle", "ticks", "tau", "states",
                      "out"]
    assert int(re.search(r"kNumPointers = (\d+);", src).group(1)) == 7
    assert "log_filter" in _build.SOURCES
    cmd = " ".join(_build.nvcc_command("log_filter", pathlib.Path("l.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd


def test_plan_constants_are_the_sources():
    """The wrapper's shared-memory arithmetic mirrors the kernel's
    constants (threads, ring, the block's shared memory)."""
    src = (_build.CSRC / _build.SOURCES["log_filter"]).read_text()

    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             src).group(1))
    assert k_log.THREADS == const("kThreads")
    assert k_log.RING_TICKS == (const("kStages") * const("kUnroll")
                                * const("kThreads"))
    assert k_log.MAX_SMEM_BYTES == const("kMaxSmem")


def _rows_edges(r):
    """(the smallest S whose tile drops to 1 row, the largest S on the
    shared-memory route) for ``r`` timeline rows."""
    drop = next(s for s in range(1, 20000)
                if k_log.plan(r, 64, s, 64)[1] == 1)
    last = max(s for s in range(drop, 20000)
               if k_log.plan(r, 64, s, 64)[0] == k_log.SHARED_MEMORY)
    return drop, last


@pytest.mark.parametrize("r, g, s, m, route, rows", [
    (1, 4183, 64, 649, "shared_memory", 16),       # the audit's filter
    (1, 25000, 64, 649, "shared_memory", 32),
    (1, 4000, 64, 649, "shared_memory", 16),
    (1, 2000, 64, 649, "shared_memory", 8),
    (1, 1, 64, 7440, "shared_memory", 8),
    (4183, 4183, 64, 649, "shared_memory", 16),
    (1, 4183, 64, 1 << 28, "shared_memory", 4),    # 2^30 ticks a tile
    (1, 4183, 64, (1 << 30) + 1, "two_launch", 0)])
def test_plan_fills_the_card(r, g, s, m, route, rows):
    assert k_log.plan(r, g, s, m) == (route, rows)


@pytest.mark.parametrize("r", [1, 64])
def test_plan_drops_rows_then_routes_long_timelines_to_two_launches(r):
    drop, last = _rows_edges(r)
    assert k_log.plan(r, 64, drop - 1, 64)[1] == 2
    assert k_log.plan(r, 64, drop, 64) == ("shared_memory", 1)
    assert k_log.plan(r, 64, last, 64) == ("shared_memory", 1)
    assert k_log.plan(r, 64, last + 1, 64) == ("two_launch", 0)
    assert k_log.tile_smem_bytes(r, last, 1) <= k_log.MAX_SMEM_BYTES
    assert k_log.tile_smem_bytes(r, last + 1, 1) > k_log.MAX_SMEM_BYTES
    # one row of ~8,000 segments still fits in 227 KB beside the ring
    assert 7500 < last < 8500


def test_pallas_log_filter_in_interpret_mode():
    """The JAX package's Pallas log_filter against the port's plain
    version, where the installed jax can load that tier at all.  Its
    associative scan reorders the recurrence, so 1e-9 (the reference's
    own bar for that tier)."""
    try:
        from repro.core.engine_backend import pallas_backend as pb
    except Exception as exc:        # the tier's own import error
        pytest.skip(f"the pallas tier does not import here: {exc!r}")
    arrays, ticks, tau = _per_device_case()
    got = tb.log_filter(_port(arrays), torch.as_tensor(ticks),
                        torch.as_tensor(tau))
    np.testing.assert_allclose(np.asarray(pb.log_filter(arrays, ticks, tau)),
                               got.numpy(), rtol=1e-9, atol=1e-9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the log_filter kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind, seed", CASES)
def test_cuda_log_filter_kernel_matches_plain(cuda, kind, seed):
    arrays, ticks, tau = _case(kind, seed)
    n0 = k_log.log_filter.launches
    got = k_log.log_filter(_port(arrays, cuda),
                           torch.as_tensor(ticks, device=cuda),
                           torch.as_tensor(tau, device=cuda))
    torch.cuda.synchronize()
    assert k_log.log_filter.launches == n0 + 1
    want = tb.log_filter(_port(arrays), torch.as_tensor(ticks),
                         torch.as_tensor(tau))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_cuda_log_filter_kernel_at_audit_width(cuda):
    """Thousands of rows of one shared train (a tile of segments staged
    in shared memory more than once) and unsorted ticks."""
    rng = np.random.default_rng(5)
    tl = loads.square_wave(0.013, 400, 240.0, 70.0)      # 800 segments
    arrays = RBank.from_timelines([tl]).arrays
    g = 3000
    ticks = rng.uniform(-1.0, 12.0, (g, 70))
    tau = np.where(rng.random(g) < 0.5, 0.8, 0.6)
    got = k_log.log_filter(_port(arrays, cuda),
                           torch.as_tensor(ticks, device=cuda),
                           torch.as_tensor(tau, device=cuda))
    want = tb.log_filter(_port(arrays), torch.as_tensor(ticks),
                         torch.as_tensor(tau))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def _long_case(r, g, s, m, seed):
    """``r`` timeline rows of up to ``s`` segments (per-device rows of
    several lengths, padded by repeating their last edge) and [g, m]
    ticks: far before the first edge, on every edge of row 0, past the
    last, and random in between."""
    rng = np.random.default_rng(seed)
    edges = np.empty((r, s + 1))
    powers = np.empty((r, s))
    n_segs = np.full(r, s)
    for i in range(r):
        k = s if i == 0 else int(rng.integers(1, s + 1))
        edges[i, :k + 1] = 0.1 + np.concatenate(
            [[0.0], np.cumsum(rng.uniform(1e-3, 5e-3, k))])
        edges[i, k + 1:] = edges[i, k]
        powers[i, :k] = rng.uniform(60.0, 300.0, k)
        powers[i, k:] = 55.0
        n_segs[i] = k
    ticks = rng.uniform(-1.0, edges.max() + 1.0, (g, m))
    ticks[:, 0] = -1e6
    ticks[:, 1] = 1e6
    ticks[:, 2] = edges[0, 0]
    ticks[:, 3] = edges[0, -1]
    on_edges = edges[0][:m - 4]
    ticks[0, 4:4 + len(on_edges)] = on_edges
    arrays = (edges, powers, np.full(r, 55.0), n_segs)
    return arrays, ticks, rng.uniform(0.01, 1.5, g)


def _card_cases():
    drop, last = _rows_edges(1)
    drop_g, last_g = _rows_edges(3)
    return {
        "g_not_a_multiple_of_rows": (1, 1003, 64, 131),
        "g_one": (1, 1, 64, 7440),
        "per_device_zero_width_padding": (300, 300, 64, 97),
        "rows_two_below_the_edge": (1, 40, drop - 1, 50),
        "rows_drop_to_one": (1, 40, drop, 50),
        "last_shared_memory_s": (1, 20, last, 60),
        "past_it_two_launches": (1, 20, last + 1, 60),
        "per_device_past_it": (3, 3, last_g + 1, 40),
        "per_device_rows_drop": (3, 3, drop_g, 40),
    }


@pytest.mark.parametrize("name", sorted(_card_cases()))
def test_cuda_log_filter_kernel_on_both_routes(cuda, name):
    """Tiles that G does not fill, one row, zero-width padding, S at the
    edge where a tile drops to one row and past it on the second route,
    and ticks far before the first edge, on every edge and past the
    last: each on the route and tile the plan gives, against the plain
    version at the kernel's bar."""
    r, g, s, m = _card_cases()[name]
    arrays, ticks, tau = _long_case(r, g, s, m, seed=len(name))
    route, rows = k_log.plan(r, g, s, m)
    before = dict(k_log.log_filter.launches_by_route)
    got = k_log.log_filter(_port(arrays, cuda),
                           torch.as_tensor(ticks, device=cuda),
                           torch.as_tensor(tau, device=cuda))
    torch.cuda.synchronize()
    before[route] += 1
    assert k_log.log_filter.launches_by_route == before
    if "past_it" in name:
        assert route == "two_launch"
    else:
        assert route == "shared_memory"
        assert (rows == 1) == ("drop" in name or "last" in name)
        if name == "g_not_a_multiple_of_rows":
            assert g % rows
    want = tb.log_filter(_port(arrays), torch.as_tensor(ticks),
                         torch.as_tensor(tau))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


def test_cuda_log_filter_kernel_at_infinite_ticks(cuda):
    """A tick at +inf reads the idle power past the last edge and one at
    -inf reads NaN, as in the plain version (whose span then reaches
    -inf); the other ticks are untouched."""
    arrays, ticks, tau = _long_case(1, 5, 40, 30, seed=3)
    ticks[:, 5] = np.inf
    ticks[:, 6] = -np.inf
    got = k_log.log_filter(_port(arrays, cuda),
                           torch.as_tensor(ticks, device=cuda),
                           torch.as_tensor(tau, device=cuda))
    want = tb.log_filter(_port(arrays), torch.as_tensor(ticks),
                         torch.as_tensor(tau))
    assert torch.isnan(want[:, 6]).all() and (want[:, 5] == 55.0).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
