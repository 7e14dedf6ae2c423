"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the JAX package's ``repro.models.moe.moe_ffn``, and the MoE decoders'
parameters and serving against the reference's.

Every call into the JAX package is pinned to its CPU backend at "highest"
matmul precision (``tests/_torch_jax_ref.py``).  Tolerances: ``y`` and
the aux loss 1e-5 (rtol and atol; the order of the f32 sums in XLA's and
PyTorch's products), routing bitwise: the top-k experts and the kept
mask equal the reference's.  The reference does not return its routing,
so :func:`_ref_dispatch` runs its routing lines (``moe.py:57-80``, one
group) in JAX.  A flip of one top-k choice would change a token's output
wholesale, so each routing test first asserts that every token's gap
between its k-th and (k+1)-th probability is far above f32 rounding
(``MARGIN``): a difference then is a fault, not a tie.
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
from repro.models import moe as rmoe  # noqa: E402
from repro.serve import engine as rengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-6
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b")


def _t(x):
    return torch.from_numpy(np.array(x))


def _layer(seed, D, F, E, Ep, shared=False):
    """A MoE layer's parameters as numpy f32 (router [D, E], experts
    [Ep, ...])."""
    rng = np.random.default_rng(seed)

    def draw(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)
    p = {"router": draw(D, E, std=0.3),
         "w_gate": draw(Ep, D, F, std=0.1), "w_up": draw(Ep, D, F, std=0.1),
         "w_down": draw(Ep, F, D, std=0.1)}
    if shared:
        p.update(shared_gate=draw(D, 2 * F, std=0.1),
                 shared_up=draw(D, 2 * F, std=0.1),
                 shared_down=draw(2 * F, D, std=0.1))
    return p


def _x(seed, B, S, D):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def _ref_dispatch(x, router, k, Ep, capacity_factor):
    """The reference's routing (its moe_ffn's lines up to ``keep``, one
    group): probabilities, top-k experts and the kept mask [T, k]."""
    T = x.shape[0] * x.shape[1]
    cap = int(max(1, (k * T * capacity_factor) // Ep))
    cap = -(-cap // 128) * 128

    def run():
        logits = jnp.einsum("td,de->te", jnp.asarray(x).reshape(T, -1),
                            jnp.asarray(router),
                            preferred_element_type=jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        _, topi = jax.lax.top_k(probs, k)
        flat = topi.reshape(T * k)
        onehot = jax.nn.one_hot(flat, Ep, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - onehot,
                                  flat[:, None], axis=1)[:, 0]
        return probs, topi, (pos < cap).reshape(T, k)
    return ref(run)


def _assert_margin(probs, k):
    """Every token's k-th probability above its (k+1)-th by more than
    MARGIN, so that no f32 difference in the router can flip a choice."""
    top = -np.sort(-probs, axis=-1)
    gap = top[:, k - 1] - top[:, k]
    assert gap.min() > MARGIN, (gap.min(), int(gap.argmin()))


def _both(x, p, E, k, cf, act="silu"):
    """(port MoEOutput, its Dispatch, reference (y, aux))."""
    with moe.record_dispatch() as rec:
        got = moe.moe_ffn(_t(x), {n: _t(v) for n, v in p.items()},
                          n_experts=E, top_k=k, capacity_factor=cf, act=act)
    assert len(rec) == 1
    want = ref(rmoe.moe_ffn, x, p, n_experts=E, top_k=k,
               capacity_factor=cf, act=act)
    return got, rec[0], want


def _routing_equal(x, p, k, Ep, cf, d):
    probs, topi, keep = _ref_dispatch(x, p["router"], k, Ep, cf)
    _assert_margin(probs, k)
    np.testing.assert_allclose(d.probs.numpy(), probs, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(d.topi.numpy(), topi)
    np.testing.assert_array_equal(d.keep.numpy(), keep)
    return keep


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_ffn_matches_the_reference(act, shared):
    """Ample capacity, every assignment kept: y, aux and routing."""
    E, Ep, k = 8, 16, 2
    p = _layer(1, 32, 48, E, Ep, shared)
    x = _x(2, 2, 24, 32)
    (y, aux), d, (want_y, want_aux) = _both(x, p, E, k, 1.25, act)
    keep = _routing_equal(x, p, k, Ep, 1.25, d)
    assert keep.all()
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(float(aux), want_aux, **TOL)


def test_moe_ffn_matches_a_dense_oracle_at_ample_capacity():
    """Every token through its top-k experts, weighted, summed in f64
    (tests/test_moe_dispatch.py's oracle): no capacity, no dispatch."""
    E, k = 8, 2
    p = _layer(3, 16, 32, E, E)
    x = _x(4, 2, 16, 16)
    y, _ = moe.moe_ffn(_t(x), {n: _t(v) for n, v in p.items()},
                       n_experts=E, top_k=k, capacity_factor=8.0)
    xt = x.reshape(-1, 16).astype(np.float64)
    logits = xt @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    topi = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    topw = np.take_along_axis(probs, topi, -1)
    topw /= topw.sum(-1, keepdims=True)
    want = np.zeros_like(xt)
    for j in range(k):
        e = topi[:, j]
        g = np.einsum("td,tdf->tf", xt, p["w_gate"][e])
        u = np.einsum("td,tdf->tf", xt, p["w_up"][e])
        h = g / (1 + np.exp(-g)) * u
        want += topw[:, j:j + 1] * np.einsum("tf,tfd->td", h,
                                             p["w_down"][e])
    np.testing.assert_allclose(y.numpy().reshape(-1, 16), want, **TOL)


@pytest.mark.parametrize("shared", [False, True])
def test_moe_ffn_drops_the_latest_assignments_as_the_reference(shared):
    """1024 tokens, 8 experts (padded to 16), top-2 at capacity_factor
    0.1: cap = 12 rounds up to 128, so 8 x 128 slots take about half of
    the 2048 assignments.  The kept mask, y and aux equal the reference's;
    an expert keeps its first cap assignments in token order; a dropped
    assignment adds nothing."""
    E, Ep, k, cf = 8, 16, 2, 0.1
    p = _layer(5, 16, 24, E, Ep, shared)
    x = _x(6, 2, 512, 16)
    (y, aux), d, (want_y, want_aux) = _both(x, p, E, k, cf)
    keep = _routing_equal(x, p, k, Ep, cf, d)
    assert moe.capacity(1024, k, cf, Ep) == 128
    assert 0.3 < 1 - keep.mean() < 0.7, keep.mean()
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(float(aux), want_aux, **TOL)
    flat_e, flat_keep = d.topi.numpy().reshape(-1), keep.reshape(-1)
    for e in range(E):
        mine = flat_keep[flat_e == e]
        assert mine[:128].all() and not mine[128:].any(), e
    # tokens whose every assignment was dropped get zero (or the shared
    # experts' output alone)
    gone = ~keep.any(-1)
    assert gone.sum() > 0
    base = np.zeros_like(want_y.reshape(-1, 16))
    if shared:
        base = ref(lambda: rmoe.gated_mlp(
            x, p["shared_gate"], p["shared_up"], p["shared_down"],
            act="silu")).reshape(-1, 16)
    np.testing.assert_allclose(y.numpy().reshape(-1, 16)[gone], base[gone],
                               **TOL)


def test_padded_experts_receive_nothing():
    """The padding experts' weights never reach y: NaN there gives the
    same y as zeros, in both packages."""
    E, Ep, k = 6, 16, 2
    p = _layer(7, 16, 24, E, Ep)
    x = _x(8, 2, 40, 16)
    want, _ = moe.moe_ffn(_t(x), {n: _t(v) for n, v in p.items()},
                          n_experts=E, top_k=k)
    for name in ("w_gate", "w_up", "w_down"):
        p[name][E:] = np.nan
    got, _ = moe.moe_ffn(_t(x), {n: _t(v) for n, v in p.items()},
                         n_experts=E, top_k=k)
    theirs = ref(rmoe.moe_ffn, x, p, n_experts=E, top_k=k)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), theirs.y, **TOL)


@pytest.mark.parametrize("tokens, k, cf, ep, want", [
    (1024, 2, 0.1, 16, 128), (4000, 4, 1.25, 64, 384),
    (4000, 8, 1.25, 48, 896), (2, 4, 1.25, 64, 128), (1, 1, 0.0, 16, 128),
    (10_000, 8, 1.25, 48, 2176)])
def test_capacity_rounds_up_to_128_as_the_reference_code(tokens, k, cf, ep,
                                                         want):
    """The reference's code rounds to 128 (its module's CAPACITY_ROUND
    says 512); the port follows the code."""
    assert moe.capacity(tokens, k, cf, ep) == want
    assert moe.CAPACITY_MULTIPLE == 128 and rmoe.CAPACITY_ROUND == 512
    cap = int(max(1, (k * tokens * cf) // ep))
    assert want == -(-cap // 128) * 128


def test_record_dispatch_collects_one_entry_per_moe_layer():
    cfg = registry.get_config("qwen2-moe-a2.7b", reduced=True).replace(
        param_dtype="float32")
    p = api.init_params(0, cfg, "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator()
                         .manual_seed(0), dtype=torch.int32)
    with moe.record_dispatch() as outer:
        with moe.record_dispatch() as inner:
            api.forward(p, cfg, {"tokens": toks})
        tf.prefill(p, cfg, {"tokens": toks}, max_seq=16)
    assert len(inner) == cfg.n_layers and len(outer) == cfg.n_layers
    for d in inner + outer:
        assert d.probs.shape == (18, cfg.n_experts)
        assert d.topi.shape == d.keep.shape == (18, cfg.top_k)
        assert d.keep.all()
    assert moe._records is None


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_expert_fan_in(arch):
    """The reference's fan-in rule covers the 4-d expert leaves [n_per,
    Ep, D, F]: std 1/sqrt(Ep·D) (the product of all but the last
    dimension over the stacked one), the 3-d router and shared experts
    1/sqrt(n_per·D)."""
    cfg = registry.get_config(arch, reduced=True)
    p = api.init_params(1, cfg, "cpu")["blocks"]["p0_attn"]["moe"]
    n_per, Ep, D = cfg.n_layers, cfg.n_experts_padded, cfg.d_model
    F = cfg.moe_d_ff
    assert p["w_gate"].shape == (n_per, Ep, D, F)
    assert p["w_down"].shape == (n_per, Ep, F, D)
    want = {"w_gate": Ep * D, "w_up": Ep * D, "w_down": Ep * F,
            "router": n_per * D}
    if cfg.n_shared_experts:
        want.update(shared_gate=n_per * D, shared_up=n_per * D,
                    shared_down=n_per * F * cfg.n_shared_experts)
    assert set(p) == set(want)
    for name, fan_in in want.items():
        std = float(p[name].float().std())
        assert abs(std * math.sqrt(fan_in) - 1) < 0.1, (name, std)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_params_refuses_unpadded_experts(arch):
    """Experts carried across with their padding (bit for bit: the model
    tests), and a tree whose experts are not padded is refused."""
    cfg = registry.get_config(arch, reduced=True)
    rcfg = rreg.get_config(arch, reduced=True)
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(3), rcfg))
    p = convert.lm_params(rp, cfg, "cpu")
    got = p["blocks"]["p0_attn"]["moe"]["w_up"]
    assert got.shape[1] == cfg.n_experts_padded > cfg.n_experts
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(rp["blocks"]["p0_attn"]["moe"]["w_up"], np.float32))
    m = rp["blocks"]["p0_attn"]["moe"]
    m["w_up"] = m["w_up"][:, :cfg.n_experts]
    with pytest.raises(ValueError, match="w_up"):
        convert.lm_params(rp, cfg, "cpu")


@pytest.mark.parametrize("arch, total, active", [
    ("olmo-1b", 1_176_764_416, 1_073_741_824),
    ("granite-moe-3b-a800m", 3_902_773_248, 807_372_288),
    ("qwen2-moe-a2.7b", 14_834_894_848, 2_066_647_040)])
def test_full_size_parameter_counts(arch, total, active):
    cfg = registry.get_config(arch)
    assert tf.param_count(cfg) == total
    assert tf.active_param_count(cfg) == active


@pytest.fixture(scope="module", params=MOE_ARCHS)
def served(request):
    cfg = registry.get_config(request.param, reduced=True).replace(
        param_dtype="float32")
    rcfg = rreg.get_config(request.param, reduced=True).replace(
        param_dtype="float32")
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
    return cfg, rcfg, rp, convert.lm_params(rp, cfg, "cpu")


@pytest.mark.parametrize("n_slots", [1, 2])
def test_engine_tokens_equal_the_reference(served, n_slots):
    """The same requests through both ServingEngines: the same tokens and
    ticks (every MoE decode step keeps all its assignments)."""
    cfg, rcfg, rp, p = served
    spec = [(8, 6), (3, 4), (11, 7)]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n, _ in spec]

    def reference():
        eng = rengine.ServingEngine(rcfg, rp, n_slots=n_slots, max_seq=32)
        reqs = [rengine.Request(i, pr, max_new_tokens=m)
                for i, (pr, (_, m)) in enumerate(zip(prompts, spec))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [list(r.generated) for r in reqs], eng.ticks
    want, want_ticks = ref(reference)
    eng = ServingEngine(cfg, p, n_slots=n_slots, max_seq=32, device="cpu")
    reqs = [Request(i, pr, max_new_tokens=m)
            for i, (pr, (_, m)) in enumerate(zip(prompts, spec))]
    for r in reqs:
        eng.submit(r)
    with moe.record_dispatch() as rec:
        eng.run()
    assert [r.generated for r in reqs] == want
    assert eng.ticks == want_ticks
    assert rec and all(bool(d.keep.all()) for d in rec)
