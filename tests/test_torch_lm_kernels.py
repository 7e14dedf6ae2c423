"""The port's two language-model kernels against the JAX package:
``rglru_scan`` (the RG-LRU recurrence) and ``flash_attention``.

Same inputs, made with numpy from a seed, go through both; every call into
the JAX package is pinned to its CPU backend at "highest" matmul precision
(``tests/_torch_jax_ref.py``).

* The plain ``rglru_scan`` equals the Pallas kernel in interpret mode
  bitwise: each step is one fused multiply-add there (XLA's CPU backend
  contracts ``a_t * h + u_t``), and the plain version emulates that FMA
  exactly.  Against the model's ``rglru_scan_ref`` (an associative scan,
  whose tree order rounds differently) it agrees within 4 ulp of the
  largest |h| (measured: 1.5); with decays in (0, 1) the rounding errors
  do not grow along time.
* The plain ``flash_attention`` (the port's ``blocked_attention``) meets
  the reference's own bars (``tests/test_kernels.py``) against the Pallas
  kernel in interpret mode and ``attention_direct_ref``: 2e-5 in f32,
  2e-2 in bf16; the online softmax sums its blocks in another order than
  one softmax over the row.  Against the reference's ``blocked_attention``
  at the same blocks it agrees within 2e-6 (the order of the f32 dot
  products).

The CUDA kernels run only on the card: their tests skip here, and
``chip_smoke.py`` phase 8a holds them against their plain versions at the
main path's shapes.  Which of ``flash_attention``'s two kernels a CUDA
input takes is a pure function of its type and ``head_dim``, tested here.
"""
import ctypes
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_jax_ref import ref  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as pallas_flash)
from repro.kernels.rglru_scan import rglru_scan as pallas_scan  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models.recurrent import rglru_scan_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import rglru_scan as krs  # noqa: E402
from repro_torch.models.layers import blocked_attention  # noqa: E402

#: tests/test_kernels.py::test_rglru_scan_vs_ref's shapes and Pallas blocks
SCAN_CASES = [(1, 64, 256, 128, 16), (2, 100, 512, 256, 32),
              (3, 17, 128, 128, 8)]
#: tests/test_kernels.py::test_flash_attention_vs_direct's cases
FLASH_CASES = [
    (64, 64, 4, 4, 32, dict(causal=True)),
    (100, 100, 4, 2, 32, dict(causal=True)),          # GQA + ragged
    (64, 64, 8, 1, 16, dict(causal=True)),            # MQA
    (64, 64, 4, 2, 32, dict(causal=False)),
    (96, 96, 2, 2, 32, dict(causal=True, window=17)),
    (64, 64, 2, 2, 32, dict(causal=True, softcap=20.0)),
    (32, 128, 2, 2, 32, dict(causal=False)),          # S != T
]
FLASH_IDS = ["causal", "gqa-ragged", "mqa", "noncausal", "window",
             "softcap", "s-ne-t"]
#: flash_attention against blocked_attention on the card, by type: f32
#: and bf16 the reference tests' bars, f16 between them
CUDA_TOL = {torch.float32: 2e-5, torch.float16: 4e-3, torch.bfloat16: 2e-2}


def _scan_inputs(b, s, d, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))).astype(
        np.float32)
    return a, rng.standard_normal((b, s, d)).astype(np.float32)


def _qkv(b, s, t, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, s, d, block_d, chunk", SCAN_CASES)
def test_plain_rglru_scan_matches_pallas_bitwise(b, s, d, block_d, chunk):
    a, u = _scan_inputs(b, s, d, s)
    want = ref(pallas_scan, a, u, block_d=block_d, chunk=chunk,
               interpret=True)
    got = krs.rglru_scan_plain(*_t(a, u))
    assert got.dtype == torch.float32 and got.shape == (b, s, d)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("b, s, d, block_d, chunk", SCAN_CASES)
def test_plain_rglru_scan_matches_the_associative_scan(b, s, d, block_d,
                                                       chunk):
    a, u = _scan_inputs(b, s, d, s + 1)
    want = ref(rglru_scan_ref, a, u)
    got = krs.rglru_scan_plain(*_t(a, u)).numpy()
    atol = 4 * np.spacing(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_plain_rglru_scan_keeps_u_type_and_f32_carry():
    """As the Pallas kernel: inputs cast to f32, the carry f32, the output
    rounded to u's type (here bf16) at the end."""
    import jax.numpy as jnp
    a, u = _scan_inputs(2, 40, 64, 3)
    ub = torch.from_numpy(u).to(torch.bfloat16)

    def pallas_bf16(a, u):
        out = pallas_scan(a, jnp.asarray(u).astype(jnp.bfloat16), block_d=64,
                          chunk=8, interpret=True)
        assert out.dtype == jnp.bfloat16
        return out.astype(jnp.float32)
    want = ref(pallas_bf16, a, ub.float().numpy())
    got = krs.rglru_scan_plain(torch.from_numpy(a), ub)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_fma_f32_rounds_once():
    """Against exact rational arithmetic, on sums that nearly cancel."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = ((-(a.astype(np.float64) * b)).astype(np.float32)
         + (rng.standard_normal(4000) * 1e-7).astype(np.float32))
    got = krs.fma_f32(*_t(a, b, c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        g = got[i]
        err = abs(Fraction(float(g)) - exact)
        for nb in (np.nextafter(g, np.float32(-np.inf)),
                   np.nextafter(g, np.float32(np.inf))):
            other = abs(Fraction(float(nb)) - exact)
            assert other > err or (other == err and not
                                   int(g.view(np.uint32)) & 1), i


def test_rglru_wrapper_runs_the_plain_version_on_the_cpu_without_launching():
    a, u = _t(*_scan_inputs(2, 33, 48, 4))
    n0 = krs.rglru_scan.launches
    assert torch.equal(krs.rglru_scan(a, u), krs.rglru_scan_plain(a, u))
    assert krs.rglru_scan.launches == n0


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s, t, hq, hkv, d, kw", FLASH_CASES, ids=FLASH_IDS)
def test_plain_flash_attention_matches_pallas_and_direct(s, t, hq, hkv, d,
                                                         kw):
    q, k, v = _qkv(2, s, t, hq, hkv, d, s + hq)
    pallas = ref(pallas_flash, q, k, v, block_q=32, block_k=32,
                 interpret=True, **kw)
    direct = ref(kref.attention_direct_ref, q, k, v, **kw)
    got = blocked_attention(*_t(q, k, v), **kw).numpy()
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, direct, rtol=2e-5, atol=2e-5)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    n0 = kfa.flash_attention.launches
    np.testing.assert_array_equal(
        kfa.flash_attention(*_t(q, k, v), **kw).numpy(), got)
    assert kfa.flash_attention.launches == n0


@pytest.mark.parametrize("s, t, hq, hkv, d, kw", FLASH_CASES, ids=FLASH_IDS)
def test_plain_blocked_attention_matches_the_reference_blocks(s, t, hq, hkv,
                                                              d, kw):
    q, k, v = _qkv(1, s, t, hq, hkv, d, s + d)
    want = ref(rlayers.blocked_attention, q, k, v, block_q=24, block_k=40,
               **kw)
    got = blocked_attention(*_t(q, k, v), block_q=24, block_k=40, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dtype, tol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_plain_flash_attention_dtypes(dtype, tol):
    """tests/test_kernels.py::test_flash_attention_dtypes: the output in
    the input type, the Pallas kernel and the direct softmax within the
    reference's bar."""
    import jax.numpy as jnp
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, 11)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    jq, jk, jv = (np.asarray(x.float().numpy()) for x in (tq, tk, tv))

    def in_type(fn, *xs, **kw):
        return fn(*(jnp.asarray(x).astype(dtype) for x in xs), **kw).astype(
            jnp.float32)
    pallas = ref(in_type, pallas_flash, jq, jk, jv, block_q=32, block_k=32,
                 interpret=True)
    direct = ref(in_type, kref.attention_direct_ref, jq, jk, jv)
    got = kfa.flash_attention(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    for want in (pallas, direct):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_plain_flash_attention_rows_without_a_valid_key_are_zero():
    """A window that leaves a query no key gives 0, as the Pallas kernel's
    guarded online softmax does."""
    q, k, v = _qkv(1, 40, 12, 2, 1, 16, 13)
    kw = dict(causal=True, window=6)
    want = ref(pallas_flash, q, k, v, block_q=8, block_k=8, interpret=True,
               **kw)
    got = blocked_attention(*_t(q, k, v), **kw).numpy()
    assert np.all(got[:, 17:] == 0.0) and np.all(want[:, 17:] == 0.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# sources, and the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, struct, fields", [
    ("rglru_scan", "ScanArgs", ["a", "u", "h"]),
    ("flash_attention", "FlashArgs", ["q", "k", "v", "o"]),
    ("flash_attention_tc", "FlashArgs", ["q", "k", "v", "o"])])
def test_kernel_sources_take_the_wrappers_pointers(name, struct, fields):
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    assert re.findall(r"\*\s*(\w+);", body) == fields
    assert int(re.search(r"kNumPointers = (\d+);", src).group(1)) == len(
        fields)
    cmd = " ".join(_build.nvcc_command(name, pathlib.Path("l.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd


@pytest.mark.parametrize("needle", [
    "wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
    "mbarrier.arrive.expect_tx", "setmaxnreg.dec", "setmaxnreg.inc",
    "CU_TENSOR_MAP_SWIZZLE_128B", "cuTensorMapEncodeTiled"])
def test_tensor_core_flash_source_uses_wgmma_and_tma(needle):
    """The 16-bit route is written for Hopper's tensor cores: wgmma
    products, K/V tiles by TMA into a ring of mbarriers, registers moved
    to the consumers with setmaxnreg; cuTensorMapEncodeTiled is looked
    up through the CUDA runtime (no -lcuda on the command line).  The
    source is read with the csrc headers it includes (hopper.cuh holds
    the helpers it shares with the backward)."""
    src = (_build.CSRC / _build.SOURCES["flash_attention_tc"]).read_text()
    src += "".join((_build.CSRC / h).read_text()
                   for h in re.findall(r'#include "(\w+\.cuh)"', src))
    assert needle in src
    cmd = _build.nvcc_command("flash_attention_tc", pathlib.Path("l.so"))
    assert "arch=compute_90a,code=sm_90a" in " ".join(cmd)
    assert not any(a.startswith("-lcuda") for a in cmd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 128, 256])
def test_flash_route_puts_16_bit_inputs_on_the_tensor_cores(dtype, d):
    assert kfa.route(dtype, d) == kfa.TENSOR_CORES
    assert kfa.KERNELS[kfa.route(dtype, d)] == "flash_attention_tc"


@pytest.mark.parametrize("dtype, d", [
    (torch.float32, 16), (torch.float32, 64), (torch.float32, 256),
    (torch.float32, 40), (torch.bfloat16, 40), (torch.float16, 40),
    (torch.bfloat16, 8), (torch.float16, 200)])
def test_flash_route_keeps_f32_and_odd_head_dims_on_the_cuda_cores(dtype,
                                                                   d):
    assert kfa.route(dtype, d) == kfa.CUDA_CORES
    assert kfa.KERNELS[kfa.route(dtype, d)] == "flash_attention"


def test_flash_routes_name_built_kernels_and_start_at_zero():
    assert set(kfa.KERNELS.values()) <= set(_build.SOURCES)
    saved = (kfa.flash_attention.launches,
             dict(kfa.flash_attention.launches_by_route))
    try:
        kfa.flash_attention.launches = 7
        kfa.flash_attention.launches_by_route[kfa.TENSOR_CORES] = 7
        kfa.reset_launches()
        assert kfa.flash_attention.launches == 0
        assert kfa.flash_attention.launches_by_route == {
            kfa.TENSOR_CORES: 0, kfa.CUDA_CORES: 0}
    finally:
        kfa.flash_attention.launches = saved[0]
        kfa.flash_attention.launches_by_route = saved[1]


def test_flash_tma_inputs_are_copied_to_an_aligned_buffer():
    """TMA takes 16-byte aligned addresses: a view 2 bytes into its
    storage is copied, an aligned one passes as it is."""
    base = torch.arange(1 + 4 * 16, dtype=torch.float32).to(torch.bfloat16)
    odd = base[1:].view(1, 4, 1, 16)
    assert odd.data_ptr() % 16 != 0
    fixed = kfa._aligned(odd)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)
    even = torch.zeros((1, 4, 1, 16), dtype=torch.bfloat16)
    assert kfa._aligned(even) is even


@pytest.mark.parametrize("path", [kfa.TENSOR_CORES, kfa.CUDA_CORES])
def test_flash_launch_route_passes_the_kernels_arguments(monkeypatch, path):
    """The one launch site, shared by the wrapper and chip_smoke.py's
    comparison of the routes: the route's kernel, the four tensors, then
    B, S, T, Hq, Hkv, D, the type's code, causal, window, softcap and
    D ** -0.5 in the order of the kernels' C entry points."""
    seen = []
    monkeypatch.setattr(kfa._launch, "launch",
                        lambda *a: seen.append(a))
    q = torch.zeros((2, 5, 6, 48), dtype=torch.bfloat16)
    k = v = torch.zeros((2, 7, 3, 48), dtype=torch.bfloat16)
    out = torch.empty_like(q)
    kfa._launch_route(path, q, k, v, out, causal=False, window=9,
                      softcap=5.0)
    (name, device, tensors, *scalars), = seen
    assert name == kfa.KERNELS[path] and device == q.device
    assert [t is x for t, x in zip(tensors, (q, k, v, out))] == [True] * 4
    assert [s.value for s in scalars[:9]] == [2, 5, 7, 6, 3, 48,
                                              kfa.DTYPE_CODES[q.dtype], 0, 9]
    assert [type(s) for s in scalars] == [ctypes.c_int] * 9 + [
        ctypes.c_float] * 2
    assert scalars[9].value == 5.0
    assert scalars[10].value == pytest.approx(48 ** -0.5, rel=1e-7)


def test_rglru_kernel_source_writes_the_fma_out():
    """-fmad=false would keep ``a * h + u`` as a multiply and an add; the
    contract is one FMA a step."""
    src = (_build.CSRC / _build.SOURCES["rglru_scan"]).read_text()
    assert "h = __fmaf_rn(ca[i], h, cu[i]);" in src
    assert "h = __fmaf_rn(pa[t * D], h, pu[t * D]);" in src
    assert "-fmad=false" in _build.NVCC_FLAGS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the rglru_scan and flash_attention "
                    "kernels have no CPU mode (chip_smoke.py runs them on "
                    "the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("b, s, d", [(1, 1, 1), (3, 17, 5), (2, 100, 513),
                                     (2, 70, 4096)])
def test_cuda_rglru_scan_matches_plain_bitwise(cuda, b, s, d):
    a, u = (x.to(cuda) for x in _t(*_scan_inputs(b, s, d, d)))
    n0 = krs.rglru_scan.launches
    got = krs.rglru_scan(a, u)
    torch.cuda.synchronize()
    assert krs.rglru_scan.launches == n0 + 1
    want = krs.rglru_scan_plain(a.cpu(), u.cpu())
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("s, t, hq, hkv, d, kw", FLASH_CASES + [
    (50, 50, 6, 2, 48, dict(window=9, softcap=5.0)),
    (40, 40, 128, 1, 64, {}),
    (70, 70, 16, 1, 256, dict(window=20)),
    (300, 300, 16, 1, 256, dict(window=64)),
    (299, 299, 16, 1, 256, dict(window=64)),
    (50, 50, 4, 2, 40, dict(window=9)),
    (100, 100, 8, 2, 128, dict(window=33)),
    (130, 130, 16, 1, 80, dict(window=64)),
    (129, 129, 4, 1, 192, {})],
    ids=FLASH_IDS + ["odd-group", "wide-group", "head-256", "main-300",
                     "main-299", "head-40", "head-128", "head-80",
                     "head-192"])
def test_cuda_flash_attention_matches_plain(cuda, dtype, s, t, hq, hkv, d,
                                            kw):
    """Every case on the route its type and head_dim give: bf16/f16 on
    the tensor cores where head_dim is a multiple of 16 (all but
    head-40), the rest on the CUDA cores; main-299 leaves the last block
    3 of its 8 positions.  head-128 and head-80 run both kernels' DMAX =
    128 instances (80 zero-filled past D on the tensor cores), head-192
    their DMAX = 256 ones."""
    q, k, v = (x.to(cuda, dtype) for x in _t(*_qkv(2, s, t, hq, hkv, d,
                                                    s + d)))
    path = (kfa.TENSOR_CORES if dtype != torch.float32 and d % 16 == 0
            else kfa.CUDA_CORES)
    assert kfa.route(dtype, d) == path
    n0 = kfa.flash_attention.launches
    by_route = dict(kfa.flash_attention.launches_by_route)
    got = kfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == n0 + 1
    by_route[path] += 1
    assert kfa.flash_attention.launches_by_route == by_route
    want = blocked_attention(q, k, v, **kw)
    assert got.dtype == dtype
    tol = CUDA_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
