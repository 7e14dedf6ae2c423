"""The port's ``step_integrate`` (the §5 protocol's integral of a held
sample series over a window) against the JAX package's numpy reference,
and the CUDA kernel against its plain version.

Same inputs, made with numpy from a seed, go through both.  The plain
version keeps the reference's prefix-sum formula and order, so it is held
at rtol = atol = 1e-12 under both rules.  The CUDA kernel sums each
window in a tree order instead of differencing a prefix sum, so against
the plain version it is held at 1e-12 × Σ|dens·dt| over the row plus
1e-12 × |tail| (the rounding of two float64 sums of those terms).  It
runs only on the card: its tests skip here.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine_backend import numpy_backend as nb  # noqa: E402
from repro_torch.engine_backend import torch_backend as tb  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import step_integrate as k_step  # noqa: E402

RTOL = ATOL = 1e-12
INF = np.inf


def _adversarial():
    """Rows of one [R, 9] batch: every window edge case of the reference
    (selection by counting on sorted, inf-padded rows)."""
    rng = np.random.default_rng(0)
    base = np.array([0.1, 0.2, 0.3, 0.45, 0.5, 0.8, 1.0, 1.3, 1.4])
    rows = [
        (base, 0.25, 1.1),                       # window inside
        (base, -1.0, 5.0),                       # window over everything
        (np.full(9, INF), 0.0, 1.0),             # row of padding only
        (np.r_[0.7, np.full(8, INF)], 0.5, 0.9),  # one sample
        (base, -2.0, 0.05),                      # before the first sample
        (np.r_[base[:5], np.full(4, INF)], 0.6, 0.9),  # after the last
        (np.r_[base[:5], np.full(4, INF)], 0.15, 3.0),  # across padding
        (base, 0.9, 0.4),                        # t0 > t1
        (np.array([0.1, 0.2, 0.2, 0.2, 0.3, 0.3, 0.6, INF, INF]),
         0.2, 0.3),                              # repeated timestamps
        (base, 0.3, 1.0),                        # edges on samples
        (base, 0.5, 0.5),                        # zero-length window
        (np.r_[base[:2], np.full(7, INF)], 0.2, 0.2),  # point on the last
    ]
    ts = np.stack([r[0] for r in rows])
    vals = rng.uniform(60.0, 250.0, ts.shape)
    return (ts, vals, np.array([r[1] for r in rows]),
            np.array([r[2] for r in rows]))


def _random(seed, n=40, m=300):
    """Sorted rows of random lengths and gaps (some repeated times),
    inf-padded, with windows that start and end anywhere."""
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.choice([0.0, 1e-3, 2e-3, 0.05], (n, m),
                              p=[0.1, 0.6, 0.25, 0.05]), axis=1)
    ts += rng.uniform(-0.5, 0.5, (n, 1))
    k = rng.integers(0, m + 1, n)
    ts[np.arange(m)[None, :] >= k[:, None]] = INF
    vals = rng.uniform(60.0, 250.0, (n, m))
    t0 = rng.uniform(-0.7, 0.6, n)
    t1 = t0 + rng.uniform(-0.1, 0.9, n)
    return ts, vals, t0, t1


def _single_column():
    ts = np.array([[0.5], [INF], [0.5], [0.5]])
    vals = np.array([[100.0], [7.0], [100.0], [100.0]])
    return ts, vals, np.array([0.0, 0.0, 0.6, 0.5]), np.array([1.0, 1.0,
                                                                0.9, 0.5])


def _empty_columns():
    return np.zeros((3, 0)), np.zeros((3, 0)), np.zeros(3), np.ones(3)


CASES = {"adversarial": _adversarial, "single_column": _single_column,
         "no_columns": _empty_columns,
         **{f"random{s}": (lambda s=s: _random(s)) for s in range(3)}}


def _torch(args, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in args]


def _tolerance(ts, vals, t0, t1, trapezoid):
    """1e-12 × (Σ|dens·dt| over each row + |tail|), from the plain
    version's own terms."""
    n, m = ts.shape
    if m == 0:
        return np.zeros(n)
    fin = np.isfinite(ts[:, 1:])
    dt = np.where(fin, ts[:, 1:], 0.0) - np.where(fin, ts[:, :-1], 0.0)
    dens = (0.5 * (vals[:, :-1] + np.where(fin, vals[:, 1:], 0.0))
            if trapezoid else vals[:, :-1])
    j0 = (ts < t0[:, None]).sum(axis=1)
    j1 = (ts <= t1[:, None]).sum(axis=1) - 1
    j1c = np.clip(j1, 0, m - 1)
    rows = np.arange(n)
    with np.errstate(invalid="ignore"):
        tail = np.abs(vals[rows, j1c] * (t1 - ts[rows, j1c]))
    tail = np.where((j1 >= j0) & (j0 < m), tail, 0.0)
    return 1e-12 * (np.abs(dens * dt).sum(axis=1) + tail)


@pytest.mark.parametrize("trapezoid", [False, True], ids=["rect", "trap"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_step_integrate_matches_numpy_reference(case, trapezoid):
    args = CASES[case]()
    want = nb.step_integrate(*args, trapezoid=trapezoid)
    got = tb.step_integrate(*_torch(args), trapezoid=trapezoid)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_step_integrate_edge_rows_are_zero():
    ts, vals, t0, t1 = _adversarial()
    got = tb.step_integrate(*_torch((ts, vals, t0, t1))).numpy()
    # padding only, before the first sample, after the last, t0 > t1
    assert got[2] == 0.0 and got[4] == 0.0 and got[5] == 0.0
    assert got[7] == 0.0
    # a point window on a sample holds nothing
    assert got[10] == 0.0 and got[11] == 0.0
    # one sample held from 0.7 to 0.9
    assert got[3] == pytest.approx(vals[3, 0] * 0.2, rel=1e-14)


def test_wrapper_runs_the_plain_version_on_the_cpu_without_launching():
    args = _torch(_random(5))
    n0 = k_step.step_integrate.launches
    for trap in (False, True):
        assert torch.equal(k_step.step_integrate(*args, trapezoid=trap),
                           tb.step_integrate(*args, trapezoid=trap))
    assert k_step.step_integrate.launches == n0


def test_wrapper_never_runs_the_plain_version_off_the_cpu():
    meta = dict(dtype=torch.float64, device=torch.device("meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        k_step.step_integrate(torch.zeros((2, 4), **meta),
                              torch.zeros((2, 4), **meta),
                              torch.zeros(2, **meta), torch.zeros(2, **meta))


def test_kernel_argument_struct_ends_with_out():
    """The wrapper passes ``inputs + [out]`` as one pointer array, in the
    source struct's field order, and builds for Hopper."""
    src = (_build.CSRC / _build.SOURCES["step_integrate"]).read_text()
    body = re.search(r"struct StepArgs \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"\*\s*(\w+);", body) == ["ts", "vals", "t0", "t1",
                                                 "out"]
    assert int(re.search(r"kNumPointers = (\d+);", src).group(1)) == 5
    cmd = " ".join(_build.nvcc_command("step_integrate",
                                       pathlib.Path("l.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd


def test_pallas_step_integrate_in_interpret_mode():
    """The JAX package's Pallas step_integrate against the port's plain
    version, where the installed jax can load that tier at all (the
    reference's own bar for that tier, 1e-12)."""
    try:
        from repro.core.engine_backend import pallas_backend as pb
    except Exception as exc:        # the tier's own import error
        pytest.skip(f"the pallas tier does not import here: {exc!r}")
    args = _adversarial()
    for trap in (False, True):
        got = tb.step_integrate(*_torch(args), trapezoid=trap)
        np.testing.assert_allclose(
            np.asarray(pb.step_integrate(*args, trapezoid=trap)),
            got.numpy(), rtol=RTOL, atol=ATOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the step_integrate kernel has no CPU "
                    "mode (chip_smoke.py runs it on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("trapezoid", [False, True], ids=["rect", "trap"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_step_integrate_kernel_matches_plain(cuda, case, trapezoid):
    args = CASES[case]()
    n0 = k_step.step_integrate.launches
    got = k_step.step_integrate(*_torch(args, cuda), trapezoid=trapezoid)
    torch.cuda.synchronize()
    assert k_step.step_integrate.launches == n0 + (args[0].shape[1] > 0)
    want = tb.step_integrate(*_torch(args), trapezoid=trapezoid).numpy()
    err = np.abs(got.cpu().numpy() - want)
    assert (err <= _tolerance(*args, trapezoid)).all(), err.max()
