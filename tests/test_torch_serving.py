"""The port's ``ServingEngine`` against the JAX package's, the slice as a
whole: recurrentgemma-9b at ``REDUCED`` sizes in float32, weights carried
across with ``convert.lm_params``, the same requests submitted to both;
the port's generated tokens must equal the reference's.

The reference engine is pinned to JAX's CPU backend at "highest" matmul
precision (``tests/_torch_jax_ref.py``).  With two slots the reference's
slots interfere (every prompt step and tick runs the whole batch at one
shared position, writing every slot's KV ring and RG-LRU state): the port
keeps that behaviour, so its tokens still equal the reference's, and a
request's tokens beside a neighbour differ from its tokens alone.

qwen2-vl-7b, an ``embeds`` config, goes through the same engines: each
step feeds the unscaled rows of ``params["embed"]`` for the tokens, as the
reference's ``_batch_for`` does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_ref import ref  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serve import engine as rengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402

ARCH = "recurrentgemma-9b"
#: (prompt length, max_new_tokens): prompts shorter and longer than the
#: 16-token window
REQUESTS = [(8, 6), (3, 4), (18, 7), (6, 5)]


@pytest.fixture(scope="module")
def model():
    cfg = registry.get_config(ARCH, reduced=True).replace(
        param_dtype="float32")
    rcfg = rreg.get_config(ARCH, reduced=True).replace(param_dtype="float32")
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
    return cfg, rcfg, rp, convert.lm_params(rp, cfg, "cpu")


def _prompts(spec, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n, _ in spec]


def _reference(rcfg, rp, n_slots, max_seq, prompts, spec):
    def run():
        eng = rengine.ServingEngine(rcfg, rp, n_slots=n_slots,
                                    max_seq=max_seq)
        reqs = [rengine.Request(i, p, max_new_tokens=m)
                for i, (p, (_, m)) in enumerate(zip(prompts, spec))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [list(r.generated) for r in reqs], eng.ticks
    return ref(run)


def _port(cfg, p, n_slots, max_seq, prompts, spec):
    eng = ServingEngine(cfg, p, n_slots=n_slots, max_seq=max_seq,
                        device="cpu")
    reqs = [Request(i, pr, max_new_tokens=m)
            for i, (pr, (_, m)) in enumerate(zip(prompts, spec))]
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert [r.request_id for r in done] == sorted(
        r.request_id for r in reqs if r.done)
    assert all(r.done for r in reqs)
    assert eng.step() == 0
    return [r.generated for r in reqs], eng.ticks


@pytest.mark.parametrize("n_slots", [1, 2])
def test_engine_tokens_equal_the_reference(model, n_slots):
    cfg, rcfg, rp, p = model
    prompts = _prompts(REQUESTS, 1)
    want, want_ticks = _reference(rcfg, rp, n_slots, 32, prompts, REQUESTS)
    got, ticks = _port(cfg, p, n_slots, 32, prompts, REQUESTS)
    assert got == want
    assert ticks == want_ticks
    assert [len(g) for g in got] == [m for _, m in REQUESTS]


def test_engine_stops_a_slot_at_max_seq(model):
    """A slot is done once its position reaches max_seq - 1, before its
    max_new_tokens."""
    cfg, rcfg, rp, p = model
    spec = [(10, 8), (4, 3)]
    prompts = _prompts(spec, 2)
    want, _ = _reference(rcfg, rp, 2, 14, prompts, spec)
    got, _ = _port(cfg, p, 2, 14, prompts, spec)
    assert got == want
    assert len(got[0]) == 3 and len(got[1]) == 3


def test_slots_interfere_as_in_the_reference(model):
    """One 8-token prompt alone and beside a second request: the shared
    position and whole-batch steps change its tokens, in both packages."""
    cfg, rcfg, rp, p = model
    spec = [(8, 6), (5, 6)]
    prompts = _prompts(spec, 0)
    alone, _ = _port(cfg, p, 1, 32, prompts[:1], spec[:1])
    beside, _ = _port(cfg, p, 2, 32, prompts, spec)
    assert alone[0] != beside[0]
    assert (alone, beside) == (
        _reference(rcfg, rp, 1, 32, prompts[:1], spec[:1])[0],
        _reference(rcfg, rp, 2, 32, prompts, spec)[0])


def test_engine_refuses_parameters_on_another_device(model):
    cfg, _, _, p = model
    meta = tf.map_tree(lambda _, x: x.to("meta"), p)
    with pytest.raises(ValueError, match="is on meta"):
        ServingEngine(cfg, meta, n_slots=1, max_seq=8, device="cpu")


def test_embeds_engine_tokens_equal_the_reference():
    """Reduced qwen2-vl-7b in float32, 2 slots, prompts shorter and
    longer than each other: the port's tokens and ticks are the
    reference's."""
    arch = "qwen2-vl-7b"
    cfg = registry.get_config(arch, reduced=True).replace(
        param_dtype="float32")
    rcfg = rreg.get_config(arch, reduced=True).replace(param_dtype="float32")
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
    p = convert.lm_params(rp, cfg, "cpu")
    spec = [(8, 6), (3, 5), (5, 4)]
    prompts = _prompts(spec, 3)
    want, want_ticks = _reference(rcfg, rp, 2, 32, prompts, spec)
    got, ticks = _port(cfg, p, 2, 32, prompts, spec)
    assert got == want and ticks == want_ticks
    assert [len(g) for g in got] == [m for _, m in spec]
