"""The port's ``fma_chain`` (the paper's benchmark load, Listing 1)
against the JAX package's Pallas kernel in interpret mode, and the CUDA
kernel against its plain version.

Same inputs, made with numpy from a seed, go through both.  Both
multiplies of the chain are exact, so the plain version equals the
reference bitwise, including where the chain is not the identity (tiny
inputs round to the grid of ``2x + 2``, ±2e38 overflows, inf and nan
propagate), and so does the CUDA kernel's FMA.  Only a nan's bits may
differ (a card, or another XLA build, writes its canonical nan where the
CPU keeps the input nan's): there a nan must meet a nan.  The kernel runs only on
the card: its tests skip here.  There is no wall-clock test on the CPU;
the chain's time linear in ``niter`` (Fig. 5) is checked on the card.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine_backend import torch_backend as tb  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fma_chain as k_fma  # noqa: E402

#: the reference's cases (tests/test_kernels.py::test_fma_chain_identity)
REFERENCE_CASES = [(256, 3, 1.0), (512, 10, 0.5), (1024, 1, 0.25),
                   (256, 0, 1.0)]
#: inputs on which the chain is not the identity, or not finite
ADVERSARIAL = [1e-8, -1e-8, 3e-39, -3e-39, 2e38, -2e38, np.inf, -np.inf,
               np.nan, -1.0 + 2.0 ** -24, 1.7e38, 0.0, -0.0, 1.0, -1.0]
CASES = ([(rows, niter, frac, 256) for rows, niter, frac in REFERENCE_CASES]
         + [(512, 7, 0.5, 128), (1024, 5, 0.6, 512), (384, 2, 0.34, 128),
            (1024, 4, 0.0, 256)])


def _x(rows, seed):
    """Seeded normals [rows, 128] float32, with the adversarial values in
    the first row of each 128-row stretch."""
    x = np.random.default_rng(seed).standard_normal((rows, 128))
    x = x.astype(np.float32)
    for r in range(0, rows, 128):
        x[r, :len(ADVERSARIAL)] = ADVERSARIAL
    return x


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _assert_same(got, want):
    """Bitwise equal, a nan anywhere meeting a nan (of any bits)."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


@pytest.mark.parametrize("rows, niter, frac, block_rows", CASES)
def test_plain_fma_chain_matches_pallas_bitwise(rows, niter, frac,
                                                block_rows):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.fma_chain import fma_chain as ref_fma_chain
    x = _x(rows, rows + niter)
    want = ref_fma_chain(jnp.asarray(x), niter, frac, block_rows=block_rows,
                         interpret=True)
    got = tb.fma_chain(torch.from_numpy(x), niter, frac, block_rows)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _assert_same(got.numpy(), want)


def test_plain_fma_chain_is_not_the_identity_everywhere():
    """Active slots round tiny inputs away and overflow ±2e38, and keep
    standard normals within the reference's 1e-6; idle slots copy every
    input through."""
    x = _x(512, 1)
    got = tb.fma_chain(torch.from_numpy(x), 3, 0.5).numpy()
    assert got[0, 0] == 0.0 and got[0, 2] == 0.0        # 1e-8, 3e-39
    assert got[0, 4] == np.inf and got[0, 5] == -np.inf  # ±2e38
    assert np.isnan(got[0, 8])
    assert not np.array_equal(got[:256], x[:256])
    np.testing.assert_array_equal(_bits(got[256:]), _bits(x[256:]))
    rows = [r for r in range(256) if r % 128]
    np.testing.assert_allclose(got[rows], x[rows], rtol=0, atol=1e-6)


def test_fma_chain_slots_follow_the_reference():
    """Python's round on grid × fraction, at least one active slot."""
    assert tb.fma_chain_slots((132 * 256, 128), 1.0, 256) == (132, 132)
    assert tb.fma_chain_slots((132 * 256, 128), 0.2, 256) == (132, 26)
    assert tb.fma_chain_slots((132 * 256, 128), 0.0, 256) == (132, 1)
    assert tb.fma_chain_slots((4 * 256, 128), 0.625, 256) == (4, 2)  # 2.5
    assert tb.fma_chain_slots((4 * 256, 128), 0.875, 256) == (4, 4)  # 3.5


def test_fma_chain_asserts_the_reference_shapes():
    with pytest.raises(AssertionError, match="128-lane rows"):
        tb.fma_chain(torch.zeros((256, 64)), 1)
    with pytest.raises(AssertionError):
        tb.fma_chain(torch.zeros((300, 128)), 1)
    with pytest.raises(AssertionError, match="128-lane rows"):
        k_fma.fma_chain(torch.zeros((256, 64)), 1)


def test_wrapper_runs_the_plain_version_on_the_cpu_without_launching():
    x = torch.from_numpy(_x(512, 3))
    n0 = k_fma.fma_chain.launches
    for frac in (1.0, 0.5):
        np.testing.assert_array_equal(
            _bits(k_fma.fma_chain(x, 4, frac).numpy()),
            _bits(tb.fma_chain(x, 4, frac).numpy()))
    assert k_fma.fma_chain.launches == n0


def test_wrapper_never_runs_the_plain_version_off_the_cpu():
    x = torch.zeros((256, 128), dtype=torch.float32,
                    device=torch.device("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        k_fma.fma_chain(x, 4)


def test_kernel_source_uses_explicit_fma_and_builds_for_hopper():
    """-fmad=false would split a written ``v*2+2`` into a multiply and an
    add: the paper's load is FMA, so the source says ``__fmaf_rn``."""
    src = (_build.CSRC / _build.SOURCES["fma_chain"]).read_text()
    assert "__fmaf_rn(v[k], 2.f, 2.f)" in src
    assert "__fmaf_rn(v[k], .5f, -1.f)" in src
    body = re.search(r"struct FmaArgs \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"\*\s*(\w+);", body) == ["x", "out"]
    assert int(re.search(r"kNumPointers = (\d+);", src).group(1)) == 2
    cmd = " ".join(_build.nvcc_command("fma_chain", pathlib.Path("l.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the fma_chain kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("rows, niter, frac, block_rows", CASES)
def test_cuda_fma_chain_kernel_matches_plain_bitwise(cuda, rows, niter, frac,
                                                     block_rows):
    x = _x(rows, rows + niter)
    n0 = k_fma.fma_chain.launches
    got = k_fma.fma_chain(torch.from_numpy(x).to(cuda), niter, frac,
                          block_rows)
    torch.cuda.synchronize()
    assert k_fma.fma_chain.launches == n0 + 1
    want = tb.fma_chain(torch.from_numpy(x), niter, frac, block_rows)
    _assert_same(got.cpu().numpy(), want.numpy())


def test_cuda_fma_chain_time_is_linear_in_niter(cuda):
    """Fig. 5: the kernel's device time against ``niter`` on one slot per
    SM, R² > 0.97 (the reference's bar) with a positive slope."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    x = torch.randn((sms * 256, 128), device=cuda)
    ns = [256, 512, 1024, 2048]
    times = []
    for n in ns:
        k_fma.fma_chain(x, n)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            k_fma.fma_chain(x, n)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 5)
    a = np.polyfit(ns, times, 1)
    pred = np.polyval(a, ns)
    r2 = 1 - (np.sum((np.asarray(times) - pred) ** 2)
              / np.sum((np.asarray(times) - np.mean(times)) ** 2))
    assert r2 > 0.97 and a[0] > 0, (times, r2)
