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
    """The wrapper passes ``inputs + [span, states, out]`` as one pointer
    array, in the source struct's field order."""
    src = (_build.CSRC / _build.SOURCES["log_filter"]).read_text()
    body = re.search(r"struct LogFilterArgs \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\*\s*(\w+);", body)
    assert fields == ["edges", "powers", "idle", "ticks", "tau", "span",
                      "states", "out"]
    assert int(re.search(r"kNumPointers = (\d+);", src).group(1)) == 8
    assert "log_filter" in _build.SOURCES
    cmd = " ".join(_build.nvcc_command("log_filter", pathlib.Path("l.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-fmad=false" in cmd


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
