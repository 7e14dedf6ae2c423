"""The port's language models (configs, layers, the RG-LRU block,
forward, prefill, decode) against the JAX package at ``REDUCED`` sizes in
float32, weights carried across with ``convert.lm_params``: every
decoder-only arch — recurrentgemma-9b (RG-LRU and local attention),
olmo-1b (dense, non-parametric norm), granite-moe-3b-a800m and
qwen2-moe-a2.7b (mixture of experts; :mod:`tests.test_torch_moe` holds the
MoE layer itself), gemma2-2b (alternating windows, soft-caps), granite-8b
and llama3-405b (GQA), xlstm-125m (mLSTM/sLSTM; :mod:`tests.test_torch_xlstm`
holds the recurrences themselves) and qwen2-vl-7b (``embeds`` inputs with
3-axis ``positions3``, M-RoPE).  seamless-m4t-medium's encoder–decoder is
in :mod:`tests.test_torch_encdec`; its configs and its ``lm_params`` are
held here.  recurrentgemma-9b's cases keep the ids they had when it was
the only arch; the others' ids start with the arch.

Every call into the JAX package is pinned to its CPU backend at "highest"
matmul precision (``tests/_torch_jax_ref.py``).  Tolerances, unless a
test says otherwise: elementwise layers 1e-6 (rtol and atol; transcendental
functions of two libraries), products and whole models 1e-5 (rtol and
atol; the order of the f32 sums in XLA's and PyTorch's products, the
associative scan against the sequential one, and the online softmax's
blocks; measured ≤ 5e-7 on logits of ~0.7).  Caches the prefill copies
(ring rolls, conv states) are compared at the same bar, since they hold
projections.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_jax_ref import ref  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import layers as rl  # noqa: E402
from repro.models import recurrent as rrec  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as pl  # noqa: E402
from repro_torch.models import recurrent as prec  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-5, atol=1e-5)
ELEM = dict(rtol=1e-6, atol=1e-6)


#: the decoder-only archs (every arch but seamless-m4t-medium), in the
#: registry's order
DECODERS = tuple(a for a in registry.ARCH_IDS
                 if not registry.get_config(a).encdec)


def _cases(*values, archs=DECODERS):
    """Parameters (arch, *value) for every decoder-only arch and value;
    recurrentgemma-9b's ids are the value's alone, as before the other
    archs were ported."""
    out = []
    for arch in archs:
        for v in values:
            v = v if isinstance(v, tuple) else (v,)
            vid = "-".join(map(str, v))
            out.append(pytest.param(arch, *v, id=vid if arch == ARCH
                                    else f"{arch}-{vid}"))
    return out


def _cfgs(dtype="float32", arch=ARCH):
    return (registry.get_config(arch, reduced=True).replace(
        param_dtype=dtype), rreg.get_config(arch, reduced=True).replace(
        param_dtype=dtype))


_MODELS = {}


def _model(arch=ARCH):
    """(port cfg, reference cfg, reference params as numpy, port params),
    made once a test process."""
    if arch not in _MODELS:
        cfg, rcfg = _cfgs(arch=arch)
        rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
        _MODELS[arch] = cfg, rcfg, rp, convert.lm_params(rp, cfg, "cpu")
    return _MODELS[arch]


def _toks(b, s, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _inputs(cfg, b, s, seed):
    """A numpy batch of ``s`` positions: tokens, or for an ``embeds``
    config (qwen2-vl) embeddings and ``positions3`` whose three axes
    differ (text positions, then a patch grid's rows and columns)."""
    if cfg.input_mode != "embeds":
        return {"tokens": _toks(b, s, seed)}
    rng = np.random.default_rng(seed)
    t = np.arange(s)
    p3 = np.stack([t, t // 4 + 1, t % 4 + 2 * (t // 8)])
    p3 = (p3[:, None, :] + np.arange(b)[None, :, None]).astype(np.int32)
    return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(
        np.float32), "positions3": p3}


def _part(batch, sl):
    """The batch's positions ``sl``."""
    return {k: v[:, :, sl] if k == "positions3" else v[:, sl]
            for k, v in batch.items()}


def _torch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# configs, specs, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, reduced", _cases(
    False, True, archs=registry.ARCH_IDS))
def test_configs_match_the_reference(arch, reduced):
    cfg = registry.get_config(arch, reduced=reduced)
    rcfg = rreg.get_config(arch, reduced=reduced)
    assert cfg.to_dict() == rcfg.to_dict()
    assert cfg.layer_kinds() == rcfg.layer_kinds()
    assert cfg.d_rec_actual == rcfg.d_rec_actual
    assert cfg.n_experts_padded == rcfg.n_experts_padded
    assert tf.group_layout(cfg) == rtf.group_layout(rcfg)
    assert ArchConfig.from_json(cfg.to_json()) == cfg


def test_full_config_layout():
    cfg = registry.get_config(ARCH)
    assert tf.group_layout(cfg) == (12, 2)
    kinds = cfg.layer_kinds()
    assert kinds.count("rglru") == 26 and kinds.count("attn") == 12


def test_arch_ids_equal_the_reference():
    assert registry.ARCH_IDS == rreg.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("no-such-arch")


@pytest.mark.parametrize("arch, reduced", _cases(False, True))
def test_param_and_cache_specs_match_the_reference(arch, reduced):
    cfg = registry.get_config(arch, reduced=reduced)
    rcfg = rreg.get_config(arch, reduced=reduced)
    for mine, theirs in ((tf.param_specs(cfg), ref(rtf.param_specs, rcfg)),
                         (tf.cache_specs(cfg, 2, 5000),
                          ref(rtf.cache_specs, rcfg, 2, 5000)),
                         (api.cache_specs(cfg, 3, 10),
                          ref(rapi.cache_specs, rcfg, 3, 10))):
        flat, _ = jax.tree_util.tree_flatten_with_path(theirs)
        want = {tuple(str(p.key) for p in path): (tuple(s.shape),
                                                  str(s.dtype))
                for path, s in flat}
        got = {path: (s.shape, str(s.dtype).replace("torch.", ""))
               for path, s in tf.leaves(mine)}
        assert got == want
    assert tf.param_count(cfg) == ref(rtf.param_count, rcfg)
    assert tf.active_param_count(cfg) == ref(rtf.active_param_count, rcfg)


def test_full_size_parameter_count():
    assert tf.param_count(registry.get_config(ARCH)) == 9_396_088_832


def test_init_params_follow_the_reference_rules():
    cfg, _ = _cfgs("bfloat16")
    p = api.init_params(3, cfg, "cpu")
    again = api.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    other = api.init_params(4, cfg, "cpu")
    specs = tf.param_specs(cfg)
    for path, x in tf.leaves(p):
        spec = _leaf(specs, path)
        assert x.shape == spec.shape and x.dtype == spec.dtype, path
        assert torch.equal(x, _leaf(again, path)), path
        name = path[-1]
        if name in ("ln1", "ln2", "final_norm"):
            assert not x.any(), path
            continue
        assert not torch.equal(x, _leaf(other, path)), path
        if name == "lam":
            # a = exp(-c softplus(lam)) at r = 0.5 lies in (0.9, 0.999)
            a = torch.exp(-prec.RGLRU_C * prec.softplus(x) * 0.5)
            assert x.dtype == torch.float32
            assert 0.9 - 1e-6 < float(a.min())
            assert float(a.max()) < 0.999 + 1e-6
    blk = p["blocks"]["p0_rglru"]
    assert abs(float(blk["conv"].float().std()) - 0.1) < 0.03
    assert abs(float(p["embed"].float().std()) - 0.02) < 0.003
    # stacked [n_per, D, Dr]: the reference's fan-in of a 3-d leaf, n_per·D
    want = 1 / math.sqrt(tf.group_layout(cfg)[0] * cfg.d_model)
    assert abs(float(blk["w_gate"].float().std()) / want - 1) < 0.1


@pytest.mark.parametrize("arch, dtype", _cases(
    "float32", "bfloat16", archs=registry.ARCH_IDS))
def test_lm_params_carries_every_leaf_bit_for_bit(arch, dtype):
    cfg, rcfg = _cfgs(dtype, arch)
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(1), rcfg))
    p = convert.lm_params(rp, cfg, "cpu")
    for path, x in tf.leaves(p):
        want = np.asarray(_leaf(rp, path))
        got = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype))
        assert str(x.dtype).replace("torch.", "") == str(want.dtype)
    rp["embed"] = rp["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        convert.lm_params(rp, cfg, "cpu")
    *parents, last = max(path for path, _ in tf.leaves(p))
    del _leaf(rp, parents)[last]
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params(rp, cfg, "cpu")


def test_unknown_block_kind_raises_as_the_reference():
    """A block kind no model has raises ``ValueError`` naming it, in the
    parameter specs and the cache specs, as the reference's does."""
    cfg = registry.get_config(ARCH, reduced=True).replace(
        block_pattern=("attn", "conv9"))
    rcfg = rreg.get_config(ARCH, reduced=True).replace(
        block_pattern=("attn", "conv9"))
    for fn, rfn in ((tf.param_specs, rtf.param_specs),
                    (lambda c: tf.cache_specs(c, 1, 8),
                     lambda c: rtf.cache_specs(c, 1, 8))):
        with pytest.raises(ValueError, match="conv9"):
            ref(rfn, rcfg)
        with pytest.raises(ValueError, match="conv9"):
            fn(cfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "nonparam_ln", "layernorm"])
@pytest.mark.parametrize("with_scale", [True, False])
def test_norms(kind, with_scale):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32) if with_scale else None
    want = ref(rl.apply_norm, kind, x, scale)
    _close(pl.apply_norm(kind, _t(x), None if scale is None else _t(scale)),
           want, ELEM)


def test_rope():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 11, 3, 16)).astype(np.float32)
    pos = np.arange(5, 16, dtype=np.int32)[None, :]
    for theta in (10_000.0, 500.0):
        want = ref(rl.apply_rope, x, pos, theta)
        _close(pl.apply_rope(_t(x), _t(pos), theta), want, ELEM)


@pytest.mark.parametrize("head_dim, sections", [
    (16, (1, 1, 2)), (128, (1, 1, 2)), (20, (2, 3, 3)), (10, (1, 1, 1))])
def test_mrope(head_dim, sections):
    """The reference's band sizes (``half * s // total``, the last band
    the rest) with three unequal axes; with the axes equal, plain RoPE."""
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 9, 3, head_dim)).astype(np.float32)
    p3 = rng.integers(0, 4000, (3, 2, 9)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        want = ref(rl.apply_mrope, x, p3, sections, theta)
        _close(pl.apply_mrope(_t(x), _t(p3), sections, theta), want, ELEM)
    pos = np.stack([np.arange(4, 13)] * 2).astype(np.int32)
    same = np.stack([pos] * 3)
    _close(pl.apply_mrope(_t(x), _t(same), sections),
           pl.apply_rope(_t(x), _t(pos)).numpy(), ELEM)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(act):
    rng = np.random.default_rng(9)
    x, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) * 0.3
                     for s in ((2, 7, 64), (64, 128), (64, 128), (128, 64)))
    want = ref(rl.gated_mlp, x, wg, wu, wd, act)
    _close(pl.gated_mlp(*map(_t, (x, wg, wu, wd)), act=act), want)


@pytest.mark.parametrize("window, softcap", [(0, 0.0), (5, 0.0), (0, 10.0),
                                             (7, 3.0)])
def test_decode_attention(window, softcap):
    rng = np.random.default_rng(10)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 12, 1, 16)).astype(np.float32)
              for _ in range(2))
    cache_len = np.array([1, 7, 12], np.int32)
    want = ref(rl.decode_attention, q, kc, vc, cache_len, window=window,
               softcap=softcap)
    got = pl.decode_attention(*map(_t, (q, kc, vc, cache_len)),
                              window=window, softcap=softcap)
    _close(got, want)


def test_causal_conv_full_and_step():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    kern = rng.standard_normal((4, 8)).astype(np.float32)
    _close(prec.causal_conv1d(_t(x), _t(kern)), ref(rrec.causal_conv1d, x,
                                                    kern), ELEM)
    buf = rng.standard_normal((2, 3, 8)).astype(np.float32)
    y, nb = ref(rrec.causal_conv1d_step, x[:, 0], buf, kern)
    gy, gb = prec.causal_conv1d_step(_t(x[:, 0]), _t(buf), _t(kern))
    _close(gy, y, ELEM)
    np.testing.assert_array_equal(gb.numpy(), nb)


def test_rglru_gates_block_and_step():
    cfg, _, rp, p = _model()
    rb = {k: v[0] for k, v in rp["blocks"]["p0_rglru"].items()
          if k != "mlp"}
    pb = tf.take(p["blocks"]["p0_rglru"], 0)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    a, u = ref(rrec.rglru_gates, x, rb)
    ga, gu = prec.rglru_gates(_t(x), pb)
    _close(ga, a)
    _close(gu, u)
    _close(prec.rglru_block(_t(x), pb), ref(rrec.rglru_block, x, rb))
    h = rng.standard_normal((2, cfg.d_rec_actual)).astype(np.float32)
    conv = rng.standard_normal((2, cfg.conv_width - 1,
                                cfg.d_rec_actual)).astype(np.float32)
    y, st = ref(rrec.rglru_block_step, x[:, 0], rrec.RGLRUState(h, conv), rb)
    gy, gst = prec.rglru_block_step(_t(x[:, 0]),
                                    prec.RGLRUState(_t(h), _t(conv)), pb)
    _close(gy, y)
    _close(gst.h, st.h)
    np.testing.assert_array_equal(gst.conv.numpy(), st.conv)
    h0 = rng.standard_normal((2, cfg.d_rec_actual)).astype(np.float32)
    _close(prec.rglru_scan_ref(ga, gu, _t(h0)),
           ref(lambda a, u, h0: rrec.rglru_scan_ref(jnp.asarray(a),
                                                    jnp.asarray(u), h0),
               a, u, h0))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch, s", _cases(8, 24, 40))
def test_forward(arch, s):
    """Logits and the aux loss (the MoE layers' sum; 0 without MoE)."""
    cfg, rcfg, rp, p = _model(arch)
    batch = _inputs(cfg, 2, s, s)
    want, want_aux = ref(rtf.forward, rp, rcfg, batch, remat=False)
    got, aux = api.forward(p, cfg, _torch(batch))
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)
    assert (float(aux) == 0.0) == (cfg.family != "moe")


@pytest.mark.parametrize("arch, s, max_seq", _cases(
    (8, 32), (16, 32), (24, 32), (40, 48), (8, 12), (20, 12)))
def test_prefill_logits_and_cache(arch, s, max_seq):
    """Prompts shorter than, as long as and longer than recurrentgemma's
    16-token window, and a cache shorter than the window: the ring's roll
    and the conv state match the reference's (a full-attention cache
    shorter than the prompt keeps its last max_seq positions, as the
    reference's does)."""
    cfg, rcfg, rp, p = _model(arch)
    batch = _inputs(cfg, 2, s, s + max_seq)
    want, wcache = ref(rtf.prefill, rp, rcfg, batch, max_seq=max_seq)
    got, cache = tf.prefill(p, cfg, _torch(batch), max_seq=max_seq)
    _close(got, want)
    specs = tf.cache_specs(cfg, 2, max_seq)
    assert {pth for pth, _ in tf.leaves(cache)} == {
        pth for pth, _ in tf.leaves(specs)}
    for path, leaf in tf.leaves(cache):
        spec = _leaf(specs, path)
        assert leaf.shape == spec.shape and leaf.dtype == spec.dtype, path
        _close(leaf, _leaf(wcache, path))


@pytest.mark.parametrize("arch, s", _cases(12, 24))
def test_prefill_then_decode_equals_prefill_and_the_reference(arch, s):
    """prefill(S-1) + decode_step(token S-1) ≡ prefill(S) at position S-1
    (tests/test_models.py::test_arch_decode_consistency's bar, 5e-5; no
    MoE assignment is dropped at these sizes), and the decode step equals
    the reference's."""
    cfg, rcfg, rp, p = _model(arch)
    batch = _inputs(cfg, 2, s, s + 1)
    head, last = _part(batch, slice(None, -1)), _part(batch, slice(-1, None))
    full, _ = tf.prefill(p, cfg, _torch(batch), max_seq=s)
    _, cache = tf.prefill(p, cfg, _torch(head), max_seq=s)
    got, new_cache = api.decode_step(p, cfg, cache,
                                     dict(_torch(last), pos=s - 1))
    assert float((got[:, 0] - full[:, -1]).abs().max()) < 5e-5
    _, rcache = ref(rtf.prefill, rp, rcfg, head, max_seq=s)
    want, rnew = ref(rtf.decode_step, rp, rcfg, rcache,
                     dict(last, pos=np.array([s - 1], np.int32)))
    _close(got, want)
    for path, leaf in tf.leaves(new_cache):
        _close(leaf, _leaf(rnew, path))


def test_greedy_decode_tokens():
    """A prompt past the window, then 10 greedy steps: the same tokens as
    the reference, logits within the bar at every step."""
    _greedy(ARCH)


@pytest.mark.parametrize("arch", [a for a in DECODERS if a != ARCH])
def test_greedy_decode_tokens_of_each_arch(arch):
    _greedy(arch)


def _greedy(arch):
    """An ``embeds`` config is fed its greedy token's (unscaled) embedding
    row, its three positions continuing one past the prompt's largest."""
    cfg, rcfg, rp, p = _model(arch)
    batch = _inputs(cfg, 2, 20, 3)
    max_seq = 40
    logits, cache = tf.prefill(p, cfg, _torch(batch), max_seq)
    rlogits, rcache = ref(rtf.prefill, rp, rcfg, batch, max_seq=max_seq)
    nxt = logits[:, -1].argmax(-1)
    rnxt = rlogits[:, -1].argmax(-1)
    mine, theirs = [], []
    for i in range(10):
        assert nxt.tolist() == rnxt.tolist(), i
        mine.append(nxt.tolist())
        theirs.append(rnxt.tolist())
        pos = 20 + i
        if cfg.input_mode == "embeds":
            p3 = batch["positions3"].max(axis=(0, 2))[None, :, None] + 1 + i
            p3 = np.repeat(p3, 3, axis=0).astype(np.int32)
            step = {"embeds": rp["embed"][rnxt][:, None],
                    "positions3": p3}
            mine_step = {"embeds": p["embed"][nxt][:, None],
                         "positions3": _t(p3)}
        else:
            step = {"tokens": rnxt[:, None].astype(np.int32)}
            mine_step = {"tokens": nxt[:, None].int()}
        lg, cache = api.decode_step(p, cfg, cache, dict(
            mine_step, pos=torch.tensor([pos])))
        rlg, rcache = ref(rtf.decode_step, rp, rcfg, rcache, dict(
            step, pos=np.array([pos], np.int32)))
        _close(lg, rlg)
        nxt, rnxt = lg[:, 0].argmax(-1), rlg[:, 0].argmax(-1)
    assert mine == theirs


def test_bf16_forward_follows_the_reference_types():
    """In bf16 the two packages round at the same places (JAX's promotion,
    written out): every logit within 2e-2 of the reference's (bf16 keeps 8
    bits; XLA may keep f32 between fused elementwise ops where PyTorch
    rounds each)."""
    cfg, rcfg = _cfgs("bfloat16")
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(2), rcfg))
    p = convert.lm_params(rp, cfg, "cpu")
    toks = _toks(2, 24, 4)
    want, _ = ref(rtf.forward, rp, rcfg, {"tokens": toks}, remat=False)
    got, _ = api.forward(p, cfg, {"tokens": _t(toks)})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
