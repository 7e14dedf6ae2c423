"""The two routes of the RG-LRU recurrence's backward: a TMA ring of time
tiles in shared memory (``csrc/rglru_scan_bwd_tma.cu``) for D a multiple
of 4 with 16-byte aligned tensors, and one thread a channel loading its
own steps (``csrc/rglru_scan_bwd.cu``) for the rest.

Here, on the CPU: the route the wrapper takes by D and alignment and the
arguments it passes, with the launch replaced by a recorder; the new
source's pointers, entry points, tensor maps and tiles; the launch
counters; and ``rglru_scan_bwd_plain`` against ``jax.vjp`` of the
reference's ``rglru_scan_ref`` at the ring's edges (S around the tile's
steps, D around its channels, B = 3), within 1e-5 of the largest
|gradient| as ``tests/test_torch_train_kernels.py`` holds it.  The
kernels run only on the card:
``tests/test_torch_train_kernels.py::test_cuda_rglru_bwd_matches_plain_bitwise``
(skipped without one) and ``chip_smoke.py`` phase 15a hold both routes
bitwise against the plain version there.
"""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_ref import ref  # noqa: E402
from repro.models.recurrent import rglru_scan_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rglru_scan as krs  # noqa: E402

TMA_NAME = krs.BWD_KERNELS[krs.TMA_RING]
T, C = krs.TMA_TILE_STEPS, krs.TMA_TILE_CHANNELS


def _source_with_headers(name):
    """Kernel ``name``'s source followed by each ``csrc`` header it
    includes."""
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    heads = re.findall(r'#include "(\w+\.cuh)"', src)
    return "\n".join([src] + [(_build.CSRC / h).read_text() for h in heads])


@pytest.fixture
def counters():
    """The backward's launch counters, restored after the test."""
    f = krs.rglru_scan_bwd
    saved = (f.launches, dict(f.launches_by_route))
    yield f
    f.launches, f.launches_by_route = saved


@pytest.fixture
def recorded(monkeypatch):
    """Every kernel launch as (library, device, tensors, scalars, entry),
    nothing launched."""
    seen = []

    def record(name, device, tensors, *scalars, entry=None):
        seen.append((name, device, list(tensors), scalars, entry))
    monkeypatch.setattr(krs._launch, "launch", record)
    return seen


def _inputs(b, s, d, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))).astype(
        np.float32)
    u, dh = (rng.standard_normal((b, s, d)).astype(np.float32)
             for _ in range(2))
    return a, u, dh


def _shifted(shape):
    """A contiguous f32 view that starts 4 bytes into its storage."""
    n = int(np.prod(shape))
    return torch.arange(1 + n, dtype=torch.float32)[1:].view(shape)


@pytest.mark.parametrize("d, offset, path", [
    (4096, False, krs.TMA_RING), (48, False, krs.TMA_RING),
    (5, False, krs.THREAD_LOADS), (513, False, krs.THREAD_LOADS),
    (32, True, krs.THREAD_LOADS)],
    ids=["4096", "48", "5", "513", "32-4-bytes-in"])
def test_backward_route_by_width_and_alignment(counters, recorded, d,
                                               offset, path):
    """D a multiple of 4 with every pointer 16-byte aligned takes the TMA
    ring, anything else the thread-loads kernel: one launch of that
    route's library with a, h, dh, da, du and B, S, D as int64, counted
    in the total and on the route."""
    shape = (2, 3, d)
    if offset:
        a, h, dh = (_shifted(shape) for _ in range(3))
        assert all(x.data_ptr() % 16 == 4 for x in (a, h, dh))
    else:
        a, h, dh = (torch.zeros(shape) for _ in range(3))
    n0, by0 = counters.launches, dict(counters.launches_by_route)
    da, du = krs._bwd_launch(a, h, dh)
    assert krs.route(d, (a, h, dh, da, du)) == path
    (name, device, tensors, scalars, entry), = recorded
    assert (name, device, entry) == (krs.BWD_KERNELS[path], a.device, None)
    assert [t is w for t, w in zip(tensors, (a, h, dh, da, du))] == [True] * 5
    assert [type(x) for x in scalars] == [ctypes.c_int64] * 3
    assert [x.value for x in scalars] == list(shape)
    by0[path] += 1
    assert (counters.launches, counters.launches_by_route) == (n0 + 1, by0)
    assert da.shape == du.shape == shape
    assert da.dtype == du.dtype == torch.float32


def test_route_reads_every_pointer():
    """One unaligned tensor among the five sends the call to the
    thread-loads kernel; D = 4 with aligned tensors takes the ring."""
    aligned = [torch.zeros((1, 2, 4)) for _ in range(5)]
    assert krs.route(4, aligned) == krs.TMA_RING
    for i in range(5):
        ts = list(aligned)
        ts[i] = _shifted((1, 2, 4))
        assert krs.route(4, ts) == krs.THREAD_LOADS
    assert krs.route(6, aligned) == krs.THREAD_LOADS


@pytest.mark.parametrize("path", [krs.TMA_RING, krs.THREAD_LOADS])
def test_bwd_launch_route_passes_the_kernels_arguments(counters, recorded,
                                                       path):
    """The one launch site of both routes: the route's library, the five
    pointers in ScanBwdArgs order, B, S, D; nothing counted."""
    a, h, dh, da, du = (torch.zeros((3, 5, 40)) for _ in range(5))
    before = (counters.launches, dict(counters.launches_by_route))
    krs._bwd_launch_route(path, a, h, dh, da, du)
    (name, _, tensors, scalars, entry), = recorded
    assert (name, entry) == (krs.BWD_KERNELS[path], None)
    assert [t is w for t, w in zip(tensors, (a, h, dh, da, du))] == [True] * 5
    assert [x.value for x in scalars] == [3, 5, 40]
    assert (counters.launches, counters.launches_by_route) == before


def test_empty_input_launches_nothing(counters, recorded):
    before = (counters.launches, dict(counters.launches_by_route))
    da, du = krs._bwd_launch(*(torch.zeros((2, 0, 8)) for _ in range(3)))
    assert da.shape == du.shape == (2, 0, 8)
    assert recorded == []
    assert (counters.launches, counters.launches_by_route) == before


def test_reset_launches_zeroes_every_count(counters):
    saved = krs.rglru_scan.launches
    krs.rglru_scan.launches = 4
    counters.launches = 3
    counters.launches_by_route[krs.TMA_RING] = 2
    counters.launches_by_route[krs.THREAD_LOADS] = 1
    krs.reset_launches()
    assert krs.rglru_scan.launches == 0
    assert counters.launches == 0
    assert counters.launches_by_route == {krs.TMA_RING: 0,
                                          krs.THREAD_LOADS: 0}
    assert set(krs.BWD_KERNELS.values()) <= set(_build.SOURCES)
    krs.rglru_scan.launches = saved


def test_cpu_tensors_take_the_plain_backward(counters, recorded):
    """On CPU tensors rglru_scan_bwd is rglru_scan_bwd_plain, bitwise,
    whatever route D would take on the card: nothing launched, nothing
    counted."""
    a, u, dh = (torch.from_numpy(x) for x in _inputs(2, 40, 36, 3))
    h = krs.rglru_scan_plain(a, u)
    before = (counters.launches, dict(counters.launches_by_route))
    got = krs.rglru_scan_bwd(a, h, dh)
    want = krs.rglru_scan_bwd_plain(a, h, dh)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert recorded == []
    assert (counters.launches, counters.launches_by_route) == before


def test_tma_source_takes_the_wrappers_pointers_and_entries():
    """The same ScanBwdArgs as the thread-loads source, field for field;
    its three C entries; built for sm_90a with the shared nvcc flags."""
    src = (_build.CSRC / _build.SOURCES[TMA_NAME]).read_text()
    body = re.search(r"struct ScanBwdArgs \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"\*\s*(\w+);", body) == ["a", "h", "dh", "da", "du"]
    assert int(re.search(r"kNumPointers = (\d+);", src).group(1)) == 5
    for entry in ("launch", "error_string", "num_pointers"):
        assert re.search(r'extern "C" [^(]* %s_%s\(' % (TMA_NAME, entry),
                         src), entry
    assert re.search(r'extern "C" int rglru_scan_bwd_tma_launch\(void\* '
                     r'const\* ptrs, int64_t B,\s+int64_t S, int64_t D, '
                     r'void\* stream\)', src)
    cmd = " ".join(_build.nvcc_command(TMA_NAME, _build.BUILD_DIR / "l.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd


def test_tma_source_tiles_are_the_wrappers():
    """TMA_TILE_STEPS and TMA_TILE_CHANNELS, which the tests and 15a use
    for the ring's edges, are the source's kSteps and kChannels; a box
    row is 128 bytes a consumer warp (no swizzle)."""
    src = (_build.CSRC / _build.SOURCES[TMA_NAME]).read_text()
    consumers = int(re.search(r"kConsumers = (\d+);", src).group(1))
    assert int(re.search(r"kSteps = (\d+);", src).group(1)) == T
    assert "kChannels = 32 * kConsumers;" in src
    assert C == 32 * consumers


@pytest.mark.parametrize("needle", [
    "cp.async.bulk.tensor", "mbarrier.try_wait", "mbarrier.arrive.expect_tx",
    "cuTensorMapEncodeTiled", "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE",
    "CU_TENSOR_MAP_SWIZZLE_NONE", "CU_TENSOR_MAP_DATA_TYPE_FLOAT32"])
def test_tma_source_fills_a_ring_by_tma(needle):
    """Boxes of 4-D f32 maps, out-of-range elements read as zeros (not
    NaN), by TMA into a ring of mbarriers, through hopper.cuh's helpers."""
    assert needle in _source_with_headers(TMA_NAME)


def test_tma_source_loads_h_a_step_early_and_a_a_step_late():
    """Row r of a stage is step t0 + r: dh at t0, a at t0 + 1 (the decay
    that step needs), h at t0 - 1 (zero-filled at t0 = 0); the helpers
    come from hopper.cuh, none is defined here."""
    src = (_build.CSRC / _build.SOURCES[TMA_NAME]).read_text()
    assert '#include "hopper.cuh"' in src
    assert re.search(r"tma_load\([^;]*&tm_a,[^;]*, t0 \+ 1, b\);", src)
    assert re.search(r"tma_load\([^;]*&tm_h,[^;]*, t0 - 1, b\);", src)
    assert re.search(r"tma_load\([^;]*&tm_dh,[^;]*, t0, b\);", src)
    for helper in ("mbar_wait(uint32_t", "tma_load(uint32_t",
                   "EncodeTiled encode_tiled("):
        assert helper not in src


def test_tma_source_has_no_atomics():
    """Every output element has one writer."""
    src = _source_with_headers(TMA_NAME)
    assert "atomic" not in src.lower().replace("no atomics", "")


@pytest.mark.parametrize("d", [C - 1, C, C + 4])
@pytest.mark.parametrize("s", [1, T - 1, T, T + 1, 2 * T + 1])
def test_plain_rglru_bwd_matches_the_reference_at_the_rings_edges(s, d):
    """rglru_scan_bwd_plain, which both routes match bitwise on the card,
    against jax.vjp of the reference's rglru_scan_ref at B = 3 and the
    TMA ring's edges: one step, a tile less one, a tile, a tile and one,
    two tiles and one; a box of channels less one, a box, a box and 4."""
    a, u, dh = _inputs(3, s, d, 7 * s + d)

    def vjp(a, u, dh):
        _, fn = jax.vjp(rglru_scan_ref, a, u)
        return fn(dh)
    ra, ru = ref(vjp, a, u, dh)
    ta, tu, tdh = (torch.from_numpy(x) for x in (a, u, dh))
    h = krs.rglru_scan_plain(ta, tu)
    da, du = krs.rglru_scan_bwd_plain(ta, h, tdh)
    assert torch.all(da[:, 0] == 0)
    for got, want in ((da, ra), (du, ru)):
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
