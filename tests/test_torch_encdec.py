"""The port's encoder–decoder (``repro_torch.models.encdec``,
seamless-m4t-medium at ``REDUCED`` sizes in float32) against the JAX
package's ``repro.models.encdec``, weights carried across with
``convert.lm_params``, inputs drawn from a seed with numpy; then
``tests/test_encdec.py``'s three properties on the port alone.

Every call into the JAX package is pinned to its CPU backend at "highest"
matmul precision (``tests/_torch_jax_ref.py``).  Tolerance 1e-5 (rtol and
atol), ``tests/test_torch_models.py``'s bar for whole models; the
properties keep ``tests/test_encdec.py``'s own bars.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_ref import ref  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import encdec as renc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import api, encdec  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def model():
    cfg = registry.get_config(ARCH, reduced=True).replace(
        param_dtype="float32")
    rcfg = rreg.get_config(ARCH, reduced=True).replace(param_dtype="float32")
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
    return cfg, rcfg, rp, convert.lm_params(rp, cfg, "cpu")


def _src(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _tgt(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _specs(tree):
    return {path: (s.shape, str(s.dtype).replace("torch.", ""))
            for path, s in tf.leaves(tree)}


def _ref_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(p.key) for p in path): (tuple(s.shape), str(s.dtype))
            for path, s in flat}


@pytest.mark.parametrize("reduced", [False, True])
def test_param_and_cache_specs_match_the_reference(reduced):
    """``api`` dispatches on ``cfg.encdec``; the cache's source side is
    sized at max_seq, as the reference's ``api.cache_specs``."""
    cfg = registry.get_config(ARCH, reduced=reduced)
    rcfg = rreg.get_config(ARCH, reduced=reduced)
    assert _specs(api.param_specs(cfg)) == _ref_specs(
        ref(rapi.param_specs, rcfg))
    assert _specs(api.cache_specs(cfg, 3, 40)) == _ref_specs(
        ref(rapi.cache_specs, rcfg, 3, 40))
    assert _specs(encdec.cache_specs(cfg, 2, 17, 9)) == _ref_specs(
        ref(renc.cache_specs, rcfg, 2, 17, 9))


def test_full_size_parameter_count():
    cfg = registry.get_config(ARCH)
    n = sum(int(np.prod(s.shape)) for _, s in tf.leaves(
        api.param_specs(cfg)))
    assert n == 715_403_264


def test_init_params_follow_the_reference_rules():
    """Drawn by ``transformer._init_leaf``'s rules, as the reference's
    ``api.init_params`` draws an encoder–decoder: the norms whose name
    holds "ln" zero (``enc_norm`` does not, and is drawn), the rest normal
    with the reference's std; a seed repeats its draw."""
    cfg = registry.get_config(ARCH, reduced=True)
    p = api.init_params(3, cfg, "cpu")
    again = api.init_params(3, cfg, "cpu")
    specs = api.param_specs(cfg)
    for path, x in tf.leaves(p):
        spec = _leaf(specs, path)
        assert x.shape == spec.shape and x.dtype == spec.dtype, path
        assert torch.equal(x, _leaf(again, path)), path
        assert (not x.any()) == (path[-1] in ("ln1", "ln2", "ln_x",
                                              "final_norm")), path
    assert abs(float(p["embed"].float().std()) - 0.02) < 0.003
    assert api.init_cache(cfg, 2, 8, "cpu")["self_k"].shape == (
        cfg.n_dec_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("ss, st", [(12, 10), (5, 9), (30, 3)])
def test_encode_and_forward_match_the_reference(model, ss, st):
    """The bidirectional encoder and the teacher-forced decoder, source
    and target of other lengths."""
    cfg, rcfg, rp, p = model
    src, tgt = _src(cfg, 2, ss, ss), _tgt(cfg, 2, st, st)
    _close(encdec.encode(p, cfg, _t(src)), ref(renc.encode, rp, rcfg, src))
    want, want_aux = ref(rapi.forward, rp, rcfg,
                         {"src_embeds": src, "tokens": tgt})
    got, aux = api.forward(p, cfg, {"src_embeds": _t(src),
                                    "tokens": _t(tgt)})
    assert got.dtype == torch.float32 and got.shape == (2, st, cfg.vocab)
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0


def test_init_cache_from_encoder_and_decode_steps_match_the_reference(
        model):
    """The cross caches from one product over the stacked x_wk/x_wv, then
    decode steps past the self cache's length (its slot pos % Tmax):
    logits and every cache leaf."""
    cfg, rcfg, rp, p = model
    src, tgt = _src(cfg, 2, 11, 1), _tgt(cfg, 2, 9, 2)
    max_tgt = 6
    cache = encdec.init_cache_from_encoder(p, cfg, _t(src), max_tgt)
    rcache = ref(renc.init_cache_from_encoder, rp, rcfg, src, max_tgt)
    assert _specs(cache) == _specs(encdec.cache_specs(cfg, 2, 11, max_tgt))
    for path, leaf in tf.leaves(cache):
        _close(leaf, _leaf(rcache, path))
    for t in range(tgt.shape[1]):
        lg, cache = api.decode_step(p, cfg, cache, {
            "tokens": _t(tgt[:, t:t + 1]), "pos": t})
        rlg, rcache = ref(rapi.decode_step, rp, rcfg, rcache, {
            "tokens": tgt[:, t:t + 1], "pos": np.array([t], np.int32)})
        _close(lg, rlg)
        for path, leaf in tf.leaves(cache):
            _close(leaf, _leaf(rcache, path))


def test_decode_leaves_the_old_cache_as_it_was(model):
    cfg, _, _, p = model
    cache = encdec.init_cache_from_encoder(p, cfg, _t(_src(cfg, 1, 4, 3)), 4)
    before = {path: leaf.clone() for path, leaf in tf.leaves(cache)}
    encdec.decode_step(p, cfg, cache, {"tokens": _t(_tgt(cfg, 1, 1, 4)),
                                       "pos": 0})
    for path, leaf in tf.leaves(cache):
        assert torch.equal(leaf, before[path]), path


def test_encdec_decode_matches_forward(model):
    """tests/test_encdec.py::test_encdec_decode_matches_forward on the
    port (its bar, 1e-3)."""
    cfg, _, _, p = model
    B, Ss, St = 2, 12, 10
    src, tgt = _t(_src(cfg, B, Ss, 5)), _t(_tgt(cfg, B, St, 6))
    full, _ = encdec.forward(p, cfg, {"src_embeds": src, "tokens": tgt})
    cache = encdec.init_cache_from_encoder(p, cfg, src, max_tgt=St)
    outs = []
    for t in range(St):
        lg, cache = encdec.decode_step(p, cfg, cache, {
            "tokens": tgt[:, t:t + 1], "pos": torch.tensor([t])})
        outs.append(lg[:, 0])
    err = float((torch.stack(outs, 1) - full).abs().max())
    assert err < 1e-3, err


def test_encdec_encoder_is_bidirectional(model):
    """Flipping a late source frame changes the logits at the first
    target position (tests/test_encdec.py's bar, 1e-6)."""
    cfg, _, _, p = model
    src, tgt = _t(_src(cfg, 1, 8, 7)), _t(_tgt(cfg, 1, 4, 8))
    lg1, _ = encdec.forward(p, cfg, {"src_embeds": src, "tokens": tgt})
    src2 = src.clone()
    src2[:, -1] = -src[:, -1]
    lg2, _ = encdec.forward(p, cfg, {"src_embeds": src2, "tokens": tgt})
    assert float((lg1[:, 0] - lg2[:, 0]).abs().max()) > 1e-6


def test_encdec_causal_decoder(model):
    """Changing the last target token leaves the earlier logits
    (tests/test_encdec.py's bar, 1e-5)."""
    cfg, _, _, p = model
    src, tgt = _t(_src(cfg, 1, 8, 9)), _t(_tgt(cfg, 1, 6, 10))
    lg1, _ = encdec.forward(p, cfg, {"src_embeds": src, "tokens": tgt})
    tgt2 = tgt.clone()
    tgt2[:, -1] = (tgt[:, -1] + 1) % cfg.vocab
    lg2, _ = encdec.forward(p, cfg, {"src_embeds": src, "tokens": tgt2})
    np.testing.assert_allclose(lg1[:, :-1].numpy(), lg2[:, :-1].numpy(),
                               atol=1e-5)


def test_serving_engine_refuses_an_encoder_decoder(model):
    cfg, _, _, p = model
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(cfg, p, n_slots=1, max_seq=8, device="cpu")


def test_entry_points_refuse_a_missing_card():
    """The encoder–decoder's parameters and cache go to the card unless
    the caller asks for the CPU; without a card they refuse."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    cfg = registry.get_config(ARCH, reduced=True)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.init_params(0, cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.init_cache(cfg, 2, 8)
