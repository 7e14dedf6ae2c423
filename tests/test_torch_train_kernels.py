"""The backward of the port's two language-model kernels against the JAX
package: ``rglru_scan_bwd`` (the RG-LRU recurrence's gradient) and
``flash_attention_bwd`` (attention's, kernels B2 and B3 on the card).

The reference has no backward kernel: it trains through ``jax.vjp`` of
its jnp oracles, ``rglru_scan_ref`` (an associative scan) and
``blocked_attention``.  Same inputs and output gradients, made with numpy
from a seed, go through ``jax.vjp`` of those (pinned to JAX's CPU backend
at "highest" matmul precision, ``tests/_torch_jax_ref.py``) and through
the port's plain backward versions, which the port's autograd Functions
run on CPU tensors.

Tolerances:
* ``rglru_scan_bwd_plain`` walks time backwards with one FMA a step, the
  reference differentiates a tree-ordered scan: within 1e-5 relative to
  the largest gradient (measured ≤ 3e-7; decays in (0, 1) keep the
  rounding from growing along time).
* ``flash_attention_bwd_plain`` is one softmax over every kept key, the
  reference's gradient flows through its online softmax's blocks: 2e-5
  (rtol and atol, the forward's f32 bar).  Against torch autograd of the
  port's own ``blocked_attention`` the same.

The CUDA kernels run only on the card: their tests here skip without
one, and ``chip_smoke.py`` phase 15a holds them against their plain
versions at adversarial and at the training shapes.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_ref import ref  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models.recurrent import rglru_scan_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import rglru_scan as krs  # noqa: E402
from repro_torch.models.layers import blocked_attention  # noqa: E402

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
#: the backward kernels against their plain versions on the card, by type,
#: relative to the largest |gradient|, or absolute where that is below 1
#: (a gradient that cancels to ~0): f32 the order of f32 sums, f16 and
#: bf16 one rounding of each gradient to the type and of the inputs
CUDA_BWD_TOL = {torch.float32: 1e-4, torch.float16: 4e-3,
                torch.bfloat16: 2e-2}

#: (b, s, t, hq, hkv, d, kwargs, id): causal, window, soft-cap, GQA/MQA,
#: non-causal, S != T, and rows that see no key (window 6 over 12 keys)
ATTN_CASES = [
    (2, 48, 48, 4, 4, 16, dict(causal=True), "causal"),
    (2, 50, 50, 4, 2, 16, dict(causal=True), "gqa-ragged"),
    (1, 40, 40, 8, 1, 8, dict(causal=True), "mqa"),
    (2, 40, 40, 4, 2, 16, dict(causal=False), "noncausal"),
    (1, 60, 60, 2, 2, 16, dict(causal=True, window=17), "window"),
    (1, 40, 40, 2, 2, 16, dict(causal=True, softcap=5.0), "softcap"),
    (1, 45, 45, 6, 2, 8, dict(causal=True, window=9, softcap=5.0),
     "window-softcap"),
    (2, 20, 70, 2, 2, 16, dict(causal=False), "s-ne-t"),
    (1, 70, 20, 4, 2, 8, dict(causal=False, window=12), "s-ne-t-window"),
    (1, 40, 12, 2, 1, 16, dict(causal=True, window=6), "masked-rows"),
]


def _scan_inputs(b, s, d, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))).astype(
        np.float32)
    u, dh = (rng.standard_normal((b, s, d)).astype(np.float32)
             for _ in range(2))
    return a, u, dh


def _attn_inputs(b, s, t, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d),
                  (b, s, hq, d)))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _ref_vjp(fn, primals, cot):
    out, vjp = jax.vjp(fn, *primals)
    return (out,) + tuple(vjp(cot))


# ---------------------------------------------------------------------------
# rglru_scan_bwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, s, d", [(1, 1, 3), (2, 17, 5), (3, 64, 48),
                                     (1, 257, 16)])
def test_plain_rglru_bwd_matches_the_reference_vjp(b, s, d):
    a, u, dh = _scan_inputs(b, s, d, s + d)
    _, ra, ru = ref(_ref_vjp, rglru_scan_ref, (a, u), dh)
    h = krs.rglru_scan_plain(*_t(a, u))
    da, du = krs.rglru_scan_bwd_plain(*_t(a), h, *_t(dh))
    for got, want in ((da, ra), (du, ru)):
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


def test_rglru_autograd_runs_the_plain_backward_on_the_cpu():
    """Under grad the wrapper goes through its Function: the forward equal
    to the plain scan, the gradients the plain backward's bitwise, no
    launch counted; with grad off the same output."""
    a, u, dh = _t(*_scan_inputs(2, 33, 24, 3))
    n0 = (krs.rglru_scan.launches, krs.rglru_scan_bwd.launches)
    a.requires_grad_(True)
    u.requires_grad_(True)
    h = krs.rglru_scan(a, u)
    ga, gu = torch.autograd.grad(h, (a, u), dh)
    h_plain = krs.rglru_scan_plain(a.detach(), u.detach())
    assert torch.equal(h.detach(), h_plain)
    da, du = krs.rglru_scan_bwd_plain(a.detach(), h_plain, dh)
    assert torch.equal(ga, da) and torch.equal(gu, du)
    with torch.no_grad():
        assert torch.equal(krs.rglru_scan(a, u), h_plain)
    assert (krs.rglru_scan.launches, krs.rglru_scan_bwd.launches) == n0


def test_rglru_autograd_keeps_the_input_types():
    a, u, dh = _t(*_scan_inputs(1, 9, 8, 5))
    a.requires_grad_(True)
    ub = u.to(torch.bfloat16).requires_grad_(True)
    h = krs.rglru_scan(a, ub)
    assert h.dtype == torch.bfloat16
    ga, gu = torch.autograd.grad(h, (a, ub), dh.to(torch.bfloat16))
    assert ga.dtype == torch.float32 and gu.dtype == torch.bfloat16


def test_rglru_bwd_source_writes_the_fma_and_product():
    """Both routes' sources (the TMA ring and the thread-loads kernel)
    write the chain's step as one ``__fmaf_rn`` of the carried g (a_{t+1}
    · g + dh_t) and the product as one ``__fmul_rn`` of g by h_{t-1}, with
    no other rounding mode or fused call; -fmad=false stays in the build's
    flags, so no product is contracted.  Comments are left out."""
    assert set(krs.BWD_KERNELS.values()) == {"rglru_scan_bwd",
                                             "rglru_scan_bwd_tma"}
    for name in krs.BWD_KERNELS.values():
        src = re.sub(r"//[^\n]*", "", (
            _build.CSRC / _build.SOURCES[name]).read_text())
        assert len(re.findall(r"__fmaf_rn\(", src)) == 1, name
        assert re.search(r"\bg = [^;]*__fmaf_rn\([\w\[\]]+, g, "
                         r"[\w\[\]]+\);", src), name
        assert len(re.findall(r"__fmul_rn\(", src)) == 1, name
        assert re.search(r"__fmul_rn\(g, [\w\[\]]+\)", src), name
        assert not re.search(r"\bfmaf?\(|__fmaf_r[zdu]|__fmul_r[zdu]|"
                             r"__fadd_r", src), name
    assert "-fmad=false" in _build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# flash_attention_bwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, s, t, hq, hkv, d, kw",
                         [c[:7] for c in ATTN_CASES],
                         ids=[c[7] for c in ATTN_CASES])
def test_plain_attention_bwd_matches_the_reference_vjp(b, s, t, hq, hkv, d,
                                                       kw):
    q, k, v, do = _attn_inputs(b, s, t, hq, hkv, d, s * t + d)

    def attn(q, k, v):
        return rlayers.blocked_attention(q, k, v, block_q=16, block_k=24,
                                         **kw)
    out, rq, rk, rv = ref(_ref_vjp, attn, (q, k, v), do)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o = blocked_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(o.numpy(), out, **ATTN_TOL)
    got = kfa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, **kw)
    for g, want in zip(got, (rq, rk, rv)):
        np.testing.assert_allclose(g.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("b, s, t, hq, hkv, d, kw",
                         [c[:7] for c in ATTN_CASES],
                         ids=[c[7] for c in ATTN_CASES])
def test_plain_attention_bwd_matches_torch_autograd(b, s, t, hq, hkv, d,
                                                    kw):
    """The plain backward against autograd of the port's own
    blocked_attention, and the wrapper's Function on CPU tensors: its
    gradients are the plain backward's bitwise, no launch counted."""
    q, k, v, do = _t(*_attn_inputs(b, s, t, hq, hkv, d, s + t + d))
    for x in (q, k, v):
        x.requires_grad_(True)
    o = blocked_attention(q, k, v, block_q=16, block_k=8, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    n0 = (kfa.flash_attention.launches, kfa.flash_attention_bwd_dq.launches,
          kfa.flash_attention_bwd_dkdv.launches)
    o2 = kfa.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(o2, (q, k, v), do)
    plain = kfa.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), o2.detach(), do, **kw)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **ATTN_TOL)
        assert torch.equal(g, p)
    assert (kfa.flash_attention.launches,
            kfa.flash_attention_bwd_dq.launches,
            kfa.flash_attention_bwd_dkdv.launches) == n0


def test_plain_attention_bwd_rows_without_a_key_get_zero_gradients():
    """Queries 17.. see none of the 12 keys through a window of 6: their
    dq is 0, and no gradient is NaN."""
    q, k, v, do = _t(*_attn_inputs(1, 40, 12, 2, 1, 16, 13))
    kw = dict(causal=True, window=6)
    o = blocked_attention(q, k, v, **kw)
    dq, dk, dv = kfa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    assert torch.all(dq[:, 17:] == 0.0)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_plain_attention_bwd_returns_the_input_type(dtype):
    q, k, v, do = (x.to(dtype) for x in
                   _t(*_attn_inputs(1, 24, 24, 4, 2, 16, 7)))
    o = blocked_attention(q, k, v)
    got = kfa.flash_attention_bwd_plain(q, k, v, o, do)
    assert [g.dtype for g in got] == [dtype] * 3
    want = kfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                         o.float(), do.float())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=2e-2,
                                   atol=2e-2)


def test_attention_with_grad_off_is_the_forward_alone():
    """Serving's path: grad off, or no input requiring grad, never enters
    the Function."""
    q, k, v, _ = _t(*_attn_inputs(1, 16, 16, 2, 2, 8, 1))
    out = kfa.flash_attention(q, k, v)
    assert out.grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert kfa.flash_attention(q, k, v).grad_fn is None
    assert type(kfa.flash_attention(q, k, v).grad_fn).__name__ == \
        "_FlashAttentionBackward"


@pytest.mark.parametrize("name, struct, fields", [
    ("rglru_scan_bwd", "ScanBwdArgs", ["a", "h", "dh", "da", "du"]),
    ("flash_attention_bwd", "BwdArgs",
     ["q", "k", "v", "o", "dout", "lse", "delta", "dq", "dk", "dv"])])
def test_backward_sources_take_the_wrappers_pointers(name, struct, fields):
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    assert re.findall(r"\*\s*(\w+);", body) == fields
    assert int(re.search(r"kNumPointers = (\d+);", src).group(1)) == len(
        fields)
    cmd = " ".join(_build.nvcc_command(name, pathlib.Path("l.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd


def test_attention_bwd_source_has_no_atomics_and_both_entries():
    """Deterministic gradients: every output element has one writer."""
    src = (_build.CSRC / _build.SOURCES["flash_attention_bwd"]).read_text()
    assert "atomic" not in src.lower().replace("no atomics", "")
    assert "flash_attention_bwd_dq_launch" in src
    assert "flash_attention_bwd_dkdv_launch" in src


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the rglru_scan_bwd and "
                    "flash_attention_bwd kernels have no CPU mode "
                    "(chip_smoke.py phase 15a runs them on the card)")
    return torch.device("cuda")


#: the TMA ring's edges: S around its tile of steps, D around its box of
#: channels, B = 3
_T, _C = krs.TMA_TILE_STEPS, krs.TMA_TILE_CHANNELS
RING_EDGES = [(3, s, d) for s in (1, _T - 1, _T, _T + 1, 2 * _T + 1)
              for d in (_C - 1, _C, _C + 4)]


@pytest.mark.parametrize("b, s, d", [(1, 1, 1), (3, 17, 5), (2, 100, 513),
                                     (2, 70, 4096)] + RING_EDGES)
def test_cuda_rglru_bwd_matches_plain_bitwise(cuda, b, s, d):
    """Each route that takes the shape, bitwise as uint32 views (dh holds
    -0.0 at its last two steps and the ring's tile edges): the wrapper's,
    one counted launch on the TMA ring for D a multiple of 4, else on the
    thread-loads kernel; and the thread-loads kernel forced on the same
    inputs where the wrapper took the ring."""
    a, u, dh = _t(*_scan_inputs(b, s, d, d))
    for e in (s - 1, max(s - 2, 0), _T - 1, _T):
        if e < s:
            dh[:, e, 0::2] = -0.0
    h = krs.rglru_scan_plain(a, u)
    ac, hc, dhc = (x.to(cuda) for x in (a, h, dh))
    path = krs.TMA_RING if d % 4 == 0 else krs.THREAD_LOADS
    n0 = (krs.rglru_scan_bwd.launches,
          krs.rglru_scan_bwd.launches_by_route[path])
    runs = {path: krs.rglru_scan_bwd(ac, hc, dhc)}
    torch.cuda.synchronize()
    assert (krs.rglru_scan_bwd.launches,
            krs.rglru_scan_bwd.launches_by_route[path]) == (n0[0] + 1,
                                                            n0[1] + 1)
    if path == krs.TMA_RING:
        outs = (torch.empty_like(ac), torch.empty_like(ac))
        krs._bwd_launch_route(krs.THREAD_LOADS, ac, hc, dhc, *outs)
        runs[krs.THREAD_LOADS] = outs
        torch.cuda.synchronize()
    want = krs.rglru_scan_bwd_plain(a, h, dh)
    for got in runs.values():
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy().view(np.uint32),
                                          w.numpy().view(np.uint32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("b, s, t, hq, hkv, d, kw",
                         [c[:7] for c in ATTN_CASES],
                         ids=[c[7] for c in ATTN_CASES])
def test_cuda_attention_bwd_matches_plain(cuda, dtype, b, s, t, hq, hkv, d,
                                          kw):
    q, k, v, do = (x.to(cuda, dtype) for x in
                   _t(*_attn_inputs(b, s, t, hq, hkv, d, s + d)))
    o = kfa.flash_attention(q, k, v, **kw)
    fns = (kfa.flash_attention_bwd_dq, kfa.flash_attention_bwd_dkdv)
    # the 16-bit cases at a head_dim that is a multiple of 16 run on the
    # tensor cores, the rest on the CUDA cores
    path = (kfa.TENSOR_CORES if dtype != torch.float32 and d % 16 == 0
            else kfa.CUDA_CORES)
    n0 = [(f.launches, f.launches_by_route[path]) for f in fns]
    got = kfa.flash_attention_bwd(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_by_route[path]) for f in fns] == [
        (n + 1, r + 1) for n, r in n0]
    want = kfa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        scale = max(float(w.float().abs().max()), 1.0)
        err = float((g.float() - w.float()).abs().max())
        assert err <= CUDA_BWD_TOL[dtype] * scale, (err, scale)
