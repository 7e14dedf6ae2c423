"""The port's mLSTM and sLSTM recurrences (``repro_torch.models.recurrent``)
and xlstm-125m's prefill cache against the JAX package's, on the CPU in
float32, inputs drawn from a seed with numpy.

Every call into the JAX package is pinned to its CPU backend at "highest"
matmul precision (``tests/_torch_jax_ref.py``).  Tolerance 1e-5 (rtol and
atol), ``tests/test_torch_models.py``'s bar for products, unless a test
says otherwise.  ``mlstm_parallel``'s three-operand einsums
(``"bhts,bhts,bshd->bthd"`` and its kin) are summed in another order by
``torch.einsum`` than by XLA; at these sizes that costs < 1e-6 on outputs
of order 1, well inside the bar.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_ref import ref  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import recurrent as rrec  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import recurrent as prec  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCH = "xlstm-125m"
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def _mlstm_inputs(b, s, h, d, seed):
    """q, k, v [b,s,h,d], log_f (a log-sigmoid) and log_i [b,s,h], f32."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    f = rng.standard_normal((b, s, h)).astype(np.float32)
    log_f = -np.log1p(np.exp(-f)).astype(np.float32)
    log_i = rng.standard_normal((b, s, h)).astype(np.float32)
    return q, k, v, log_f, log_i


@pytest.mark.parametrize("s, chunk", [(37, 8), (32, 8), (5, 8), (40, 16)])
def test_mlstm_parallel_matches_the_reference(s, chunk):
    """S = 37 is not a multiple of the chunk: the padding's -1e9 input
    gates and 0 forget gates, as the reference pads."""
    args = _mlstm_inputs(2, s, 2, 16, s)
    want = ref(rrec.mlstm_parallel, *args, chunk=chunk)
    got = prec.mlstm_parallel(*map(_t, args), chunk=chunk)
    assert got.shape == (2, s, 2, 16) and got.dtype == torch.float32
    _close(got, want)


def test_mlstm_parallel_carries_a_non_finite_score_as_the_reference():
    """``w_intra * qk * 0 + w_intra``: an infinite q·k makes n_intra nan
    in both packages, and the outputs agree on which entries are not
    finite."""
    q, k, v, log_f, log_i = _mlstm_inputs(1, 16, 1, 8, 3)
    q[0, 5, 0, 0] = np.inf
    want = ref(rrec.mlstm_parallel, q, k, v, log_f, log_i, chunk=8)
    got = prec.mlstm_parallel(*map(_t, (q, k, v, log_f, log_i)),
                              chunk=8).numpy()
    assert not np.isfinite(want).all()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


def test_mlstm_step_matches_the_reference():
    q, k, v, log_f, log_i = _mlstm_inputs(2, 1, 3, 16, 4)
    rng = np.random.default_rng(5)
    st = (rng.standard_normal((2, 3, 16, 16)).astype(np.float32),
          rng.standard_normal((2, 3, 16)).astype(np.float32),
          rng.standard_normal((2, 3)).astype(np.float32))
    args = (q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], log_i[:, 0])
    y, new = ref(rrec.mlstm_step, *args, rrec.MLSTMState(*st))
    gy, gnew = prec.mlstm_step(*map(_t, args),
                               prec.MLSTMState(*map(_t, st)))
    _close(gy, y)
    for a, b in zip(gnew, new):
        _close(a, b)


def test_mlstm_parallel_equals_the_step_loop():
    """The reference's own property (tests/test_models.py::
    test_mlstm_parallel_matches_step, its bar 2e-4): the chunked form
    equals the sequential recurrence."""
    q, k, v, log_f, log_i = map(_t, _mlstm_inputs(2, 37, 2, 16, 7))
    ypar = prec.mlstm_parallel(q, k, v, log_f, log_i, chunk=8)
    st = prec.MLSTMState(torch.zeros(2, 2, 16, 16), torch.zeros(2, 2, 16),
                         torch.zeros(2, 2))
    outs = []
    for t in range(37):
        y, st = prec.mlstm_step(q[:, t], k[:, t], v[:, t], log_f[:, t],
                                log_i[:, t], st)
        outs.append(y)
    np.testing.assert_allclose(ypar.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-4, atol=2e-4)


def _slstm_params(d, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
            for k in ("w_z", "w_i", "w_f", "w_o", "r_z", "r_i", "r_f",
                      "r_o")}


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_seq_matches_the_reference(with_state):
    p = _slstm_params(24, 8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 13, 24)).astype(np.float32)
    state = None
    if with_state:
        c, h, m = (rng.standard_normal((2, 24)).astype(np.float32)
                   for _ in range(3))
        n = np.abs(rng.standard_normal((2, 24))).astype(np.float32) + 0.5
        state = (c, n, h, m)
    y, final = ref(rrec.slstm_seq, x, p, state)
    gy, gfinal = prec.slstm_seq(_t(x), {k: _t(v) for k, v in p.items()},
                                None if state is None else
                                tuple(map(_t, state)))
    assert gy.shape == (2, 13, 24)
    _close(gy, y)
    for a, b in zip(gfinal, final):
        _close(a, b)


def test_slstm_init_state_is_the_reference():
    got = prec.slstm_init_state(3, 5)
    want = ref(rrec.slstm_init_state, 3, 5)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.fixture(scope="module")
def model():
    cfg = registry.get_config(ARCH, reduced=True).replace(
        param_dtype="float32")
    rcfg = rreg.get_config(ARCH, reduced=True).replace(param_dtype="float32")
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
    return cfg, rcfg, rp, convert.lm_params(rp, cfg, "cpu")


def test_xlstm_specs_keep_the_slstm_weights_f32():
    """The sLSTM's recurrent weights and the mLSTM's ``w_if`` are f32
    whatever ``param_dtype`` is; ``ln1`` is in the parameters' type and
    neither block has an ``ln2``."""
    specs = tf.param_specs(registry.get_config(ARCH))
    ml, sl = specs["blocks"]["p0_mlstm"], specs["blocks"]["p1_slstm"]
    assert ml["w_if"].dtype == torch.float32
    assert ml["wq"].dtype == ml["ln1"].dtype == torch.bfloat16
    assert {k for k, s in sl.items() if s.dtype == torch.float32} == {
        "w_z", "w_i", "w_f", "w_o", "r_z", "r_i", "r_f", "r_o"}
    assert sl["ln1"].dtype == torch.bfloat16
    assert "ln2" not in ml and "ln2" not in sl


@pytest.mark.parametrize("s", [8, 21, 40])
def test_xlstm_prefill_cache_matches_the_reference(model, s):
    """The mLSTM state from the reference's sequential step loop over S
    (not the chunked form), the sLSTM's final state, and the logits; S =
    21 and 40 are not multiples of the reduced chunk (16)."""
    cfg, rcfg, rp, p = model
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (2, s)).astype(
        np.int32)
    want, wcache = ref(rtf.prefill, rp, rcfg, {"tokens": toks}, max_seq=s)
    got, cache = tf.prefill(p, cfg, {"tokens": _t(toks)}, max_seq=s)
    _close(got, want)
    paths = [path for path, _ in tf.leaves(cache)]
    assert sorted(paths) == sorted(
        ("blocks", k, f) for k, fs in (("p0_mlstm", "Smn"),
                                       ("p1_slstm", "cnhm")) for f in fs)
    for path, leaf in tf.leaves(cache):
        want_leaf = wcache
        for key in path:
            want_leaf = want_leaf[key]
        assert leaf.dtype == torch.float32
        _close(leaf, want_leaf)


def test_xlstm_decode_steps_match_the_reference(model):
    """Five decode steps after a prefill: logits and every state leaf."""
    cfg, rcfg, rp, p = model
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 25)).astype(
        np.int32)
    _, cache = tf.prefill(p, cfg, {"tokens": _t(toks[:, :20])}, max_seq=25)
    _, rcache = ref(rtf.prefill, rp, rcfg, {"tokens": toks[:, :20]},
                    max_seq=25)
    for t in range(20, 25):
        lg, cache = api.decode_step(p, cfg, cache, {
            "tokens": _t(toks[:, t:t + 1]), "pos": t})
        rlg, rcache = ref(rtf.decode_step, rp, rcfg, rcache, {
            "tokens": toks[:, t:t + 1], "pos": np.array([t], np.int32)})
        _close(lg, rlg)
        for path, leaf in tf.leaves(cache):
            want_leaf = rcache
            for key in path:
                want_leaf = want_leaf[key]
            _close(leaf, want_leaf)
