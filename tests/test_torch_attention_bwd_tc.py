"""The two routes of attention's backward: kernels B2 and B3 on Hopper's
tensor cores (``csrc/flash_attention_bwd_tc.cu``, ``wgmma`` and TMA) for
bf16/f16 with ``head_dim`` a multiple of 16, and on the CUDA cores
(``csrc/flash_attention_bwd.cu``) for the rest.

Here, on the CPU: the route the wrappers take (the forward's rule,
``route(dtype, head_dim)``) and the arguments they pass, with the
launch replaced by a recorder; the new source's pointers, entry points
and Hopper instructions; the launch counters; and that CPU tensors still
take the plain backward.  The kernels run only on the card:
``tests/test_torch_train_kernels.py::test_cuda_attention_bwd_matches_plain``
(skipped without one) and ``chip_smoke.py`` phase 15a hold both routes
against the plain backward there.
"""
import ctypes
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402

DTYPES = [torch.float32, torch.float16, torch.bfloat16]
HEAD_DIMS = [64, 80, 72, 128, 256]
BWD_FIELDS = ["q", "k", "v", "o", "dout", "lse", "delta", "dq", "dk", "dv"]
TC_SOURCE = _build.SOURCES["flash_attention_bwd_tc"]


def _source_with_headers(name):
    """Kernel ``name``'s source followed by each ``csrc`` header it
    includes."""
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    heads = re.findall(r'#include "(\w+\.cuh)"', src)
    return "\n".join([src] + [(_build.CSRC / h).read_text() for h in heads])


@pytest.fixture
def counters():
    """The backward's launch counters, restored after the test."""
    fns = (kfa.flash_attention_bwd_dq, kfa.flash_attention_bwd_dkdv)
    saved = [(f.launches, dict(f.launches_by_route)) for f in fns]
    yield fns
    for f, (n, by_route) in zip(fns, saved):
        f.launches, f.launches_by_route = n, by_route


@pytest.fixture
def recorded(monkeypatch):
    """Every kernel launch as (library, device, tensors, scalars, entry),
    nothing launched."""
    seen = []

    def record(name, device, tensors, *scalars, entry=None):
        seen.append((name, device, list(tensors), scalars, entry))
    monkeypatch.setattr(kfa._launch, "launch", record)
    return seen


def _inputs(dtype, d, b=2, s=5, t=7, hq=6, hkv=3, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for shape in ((b, s, hq, d), (b, t, hkv, d),
                                     (b, t, hkv, d), (b, s, hq, d),
                                     (b, s, hq, d))]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_takes_the_forwards_route(counters, recorded, dtype, d):
    """B2 and B3 launch the library of route(dtype, head_dim): the tensor
    cores for bf16/f16 at a multiple of 16, else the CUDA cores; each
    counts one launch in its total and on that route."""
    q, k, v, out, dout = _inputs(dtype, d)
    path = kfa.route(dtype, d)
    assert path == (kfa.TENSOR_CORES if dtype != torch.float32
                    and d % 16 == 0 else kfa.CUDA_CORES)
    before = [(f.launches, dict(f.launches_by_route)) for f in counters]
    kw = dict(causal=True, window=0, softcap=0.0)
    dq, lse, delta = kfa.flash_attention_bwd_dq(q, k, v, out, dout, **kw)
    dk, dv = kfa.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, **kw)
    lib = kfa.BWD_KERNELS[path]
    assert [(r[0], r[4]) for r in recorded] == [
        (lib, f"{lib}_dq_launch"), (lib, f"{lib}_dkdv_launch")]
    for f, (n, by_route) in zip(counters, before):
        by_route[path] += 1
        assert (f.launches, f.launches_by_route) == (n + 1, by_route)
    assert dq.shape == q.shape and dq.dtype == dtype
    assert lse.shape == delta.shape == (2, 6, 5)
    assert lse.dtype == delta.dtype == torch.float32
    assert dk.shape == dv.shape == k.shape and dk.dtype == dtype


@pytest.mark.parametrize("kernel", ["dq", "dkdv"])
@pytest.mark.parametrize("path", [kfa.TENSOR_CORES, kfa.CUDA_CORES])
def test_bwd_launch_route_passes_the_kernels_arguments(counters, recorded,
                                                       path, kernel):
    """The one launch site of both routes: the route's library and entry,
    the ten pointers in BwdArgs order (B2 writes lse, delta and dq, B3
    reads lse and delta and writes dk and dv), then B, S, T, Hq, Hkv, D,
    the type's code, causal, window, softcap and D ** -0.5; nothing
    counted."""
    q, k, v, out, dout = _inputs(torch.bfloat16, 48)
    before = [(f.launches, dict(f.launches_by_route)) for f in counters]
    kw = dict(causal=False, window=9, softcap=5.0)
    if kernel == "dq":
        dq, lse, delta = kfa._bwd_launch_route(path, kernel, q, k, v, out,
                                               dout, **kw)
        want = [q, k, v, out, dout, lse, delta, dq, None, None]
    else:
        lse = torch.zeros((2, 6, 5))
        delta = torch.zeros((2, 6, 5))
        dk, dv = kfa._bwd_launch_route(path, kernel, q, k, v, None, dout,
                                       lse, delta, **kw)
        want = [q, k, v, None, dout, lse, delta, None, dk, dv]
    (name, device, tensors, scalars, entry), = recorded
    lib = kfa.BWD_KERNELS[path]
    assert (name, device, entry) == (lib, q.device, f"{lib}_{kernel}_launch")
    assert [t is w for t, w in zip(tensors, want)] == [True] * 10
    assert [s.value for s in scalars[:9]] == [
        2, 5, 7, 6, 3, 48, kfa.DTYPE_CODES[torch.bfloat16], 0, 9]
    assert [type(s) for s in scalars] == [ctypes.c_int] * 9 + [
        ctypes.c_float] * 2
    assert scalars[9].value == 5.0
    assert scalars[10].value == pytest.approx(48 ** -0.5, rel=1e-7)
    assert [(f.launches, f.launches_by_route) for f in counters] == before


def test_tensor_core_route_copies_unaligned_tma_inputs(recorded):
    """TMA takes 16-byte aligned addresses: q, k, v, O and dO that start
    2 bytes into their storage reach the tensor-core kernel as aligned
    copies; the CUDA-core route passes them as they are."""
    def shifted(shape):
        n = int(np.prod(shape))
        base = torch.arange(1 + n, dtype=torch.float32).to(torch.bfloat16)
        return base[1:].view(shape)
    q, out, dout = (shifted((1, 4, 2, 16)) for _ in range(3))
    k, v = (shifted((1, 4, 1, 16)) for _ in range(2))
    assert all(x.data_ptr() % 16 for x in (q, k, v, out, dout))
    kw = dict(causal=True, window=0, softcap=0.0)
    kfa._bwd_launch_route(kfa.TENSOR_CORES, "dq", q, k, v, out, dout, **kw)
    kfa._bwd_launch_route(kfa.CUDA_CORES, "dq", q, k, v, out, dout, **kw)
    tc, cc = (r[2][:5] for r in recorded)
    assert all(t.data_ptr() % 16 == 0 for t in tc)
    assert all(torch.equal(t, x) for t, x in zip(tc, (q, k, v, out, dout)))
    assert [t is x for t, x in zip(cc, (q, k, v, out, dout))] == [True] * 5


def test_reset_launches_zeroes_the_backwards_routes(counters):
    for f in counters:
        f.launches = 3
        f.launches_by_route[kfa.TENSOR_CORES] = 2
        f.launches_by_route[kfa.CUDA_CORES] = 1
    kfa.reset_launches()
    for f in counters:
        assert f.launches == 0
        assert f.launches_by_route == {kfa.TENSOR_CORES: 0,
                                       kfa.CUDA_CORES: 0}
    assert set(kfa.BWD_KERNELS) == set(kfa.KERNELS)
    assert set(kfa.BWD_KERNELS.values()) <= set(_build.SOURCES)


@pytest.mark.parametrize("dtype, d", [(torch.bfloat16, 64),
                                      (torch.float16, 80),
                                      (torch.bfloat16, 72),
                                      (torch.float32, 128)])
def test_cpu_tensors_take_the_plain_backward(counters, recorded, dtype, d):
    """On CPU tensors flash_attention_bwd is flash_attention_bwd_plain,
    bitwise, whatever route the type and head_dim would take on the card:
    nothing launched, nothing counted."""
    q, k, v, _, dout = _inputs(dtype, d, seed=d)
    kw = dict(causal=True, window=4, softcap=5.0)
    out = kfa.flash_attention(q, k, v, **kw)
    before = [(f.launches, dict(f.launches_by_route)) for f in counters]
    got = kfa.flash_attention_bwd(q, k, v, out, dout, **kw)
    want = kfa.flash_attention_bwd_plain(q, k, v, out, dout, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)
    assert recorded == []
    assert [(f.launches, f.launches_by_route) for f in counters] == before


def test_tensor_core_backward_source_takes_the_wrappers_pointers():
    """The same BwdArgs as the CUDA-core source, field for field; both C
    entries; built for sm_90a."""
    src = (_build.CSRC / TC_SOURCE).read_text()
    body = re.search(r"struct BwdArgs \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"\*\s*(\w+);", body) == BWD_FIELDS
    assert int(re.search(r"kNumPointers = (\d+);", src).group(1)) == 10
    for entry in ("flash_attention_bwd_tc_dq_launch",
                  "flash_attention_bwd_tc_dkdv_launch",
                  "flash_attention_bwd_tc_error_string",
                  "flash_attention_bwd_tc_num_pointers"):
        assert f'extern "C"' in src and f" {entry}(" in src
    cmd = " ".join(_build.nvcc_command("flash_attention_bwd_tc",
                                       pathlib.Path("l.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd


def test_tensor_core_backward_source_has_no_atomics():
    """Deterministic gradients: every output element has one writer."""
    src = _source_with_headers("flash_attention_bwd_tc")
    assert "atomic" not in src.lower().replace("no atomics", "")


@pytest.mark.parametrize("needle", [
    "wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
    "mbarrier.arrive.expect_tx", "setmaxnreg.dec", "setmaxnreg.inc",
    "CU_TENSOR_MAP_SWIZZLE_128B", "cuTensorMapEncodeTiled"])
def test_tensor_core_backward_source_uses_wgmma_and_tma(needle):
    """Written for Hopper's tensor cores: wgmma products, Q/dO and K/V
    tiles by TMA into rings of mbarriers, registers moved to the
    consumers with setmaxnreg."""
    assert needle in _source_with_headers("flash_attention_bwd_tc")


def test_attention_kernels_share_the_hopper_header():
    """The forward and the backward on the tensor cores include one
    header of mbarrier, TMA and wgmma helpers and define none of them
    themselves."""
    for name in ("flash_attention_tc", "flash_attention_bwd_tc"):
        src = (_build.CSRC / _build.SOURCES[name]).read_text()
        assert '#include "hopper.cuh"' in src
        for helper in ("gmma_desc(uint32_t", "mbar_wait(uint32_t",
                       "tma_load(uint32_t", "REPRO_WGMMA_RS_N256"):
            assert helper not in src
    header = (_build.CSRC / "hopper.cuh").read_text()
    assert "#pragma once" in header
