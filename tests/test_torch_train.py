"""The port's training path against the JAX package: the loss and its
gradients for every arch, AdamW, int8 compression, the data pipeline,
the loop's straggler and energy accounting, checkpoints, and the
reference's own training properties (``tests/test_training.py``) run on
the port, on the CPU.

Inputs are made with numpy from seeds; weights cross with
``convert.lm_params``, optimizer states with ``convert.adamw_state``; every
call into the JAX package is pinned to its CPU backend at "highest"
matmul precision (``tests/_torch_jax_ref.py``).

Tolerances:
* loss 1e-5 relative; gradients per leaf within a relative L2 of 1e-4 of
  the reference's (the order of f32 sums in two libraries' products, the
  online softmax's blocks and the associative scan against the
  sequential one; a leaf of gradient exactly 0 must be 0);
* ``adamw.update`` 1e-6 relative to each leaf's largest |value|, with
  the same gradients carried in, apart from the gradients: a first Adam
  step is ≈ sign(g), which would amplify a gradient's last-bit
  differences.  Under clipping the global norm's f32 sum, taken in
  another order, may differ by an ulp, and a moment whose terms cancel
  across steps keeps that absolute error on a smaller value;
* the quantizer, the data pipeline and the straggler counter bitwise;
* the energy ledger 1e-12 relative, with the reference's sensor carried
  across by ``convert.onboard_sensor`` and its noise draws substituted
  (``tests/_torch_draws.py``).
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import _torch_draws  # noqa: E402
from _torch_jax_ref import ref  # noqa: E402
from repro.ckpt import checkpoint as rckpt  # noqa: E402
from repro.configs import base as rbase  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.core import activity as ract  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import compress as rcompress  # noqa: E402
from repro.train import loop as rloop  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt import checkpoint as pckpt  # noqa: E402
from repro_torch.common.tree import flatten_with_paths, tree_leaves  # noqa
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import activity as pact  # noqa: E402
from repro_torch.data import pipeline as ppipe  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402
from repro_torch.train import loop, step  # noqa: E402

CPU = "cpu"
SHAPE = pbase.ShapeCell("tiny", 32, 4, "train")
RSHAPE = rbase.ShapeCell("tiny", 32, 4, "train")
GRAD_REL_L2 = 1e-4
LOSS_REL = 1e-5
ADAM_REL = 1e-6
LEDGER_REL = 1e-12
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _cfgs(arch, dtype="float32"):
    return (registry.get_config(arch, reduced=True).replace(
        param_dtype=dtype), rreg.get_config(arch, reduced=True).replace(
        param_dtype=dtype))


def _ref_params(rcfg, seed=0):
    return ref(lambda: rapi.init_params(jax.random.PRNGKey(seed), rcfg))


def _batch(rcfg, shape=RSHAPE, seed=3, step_=0):
    """The reference loader's batch (numpy)."""
    return rpipe.SyntheticTokens(rcfg, shape, seed=seed).batch_at(step_)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _leaves(tree):
    """{dotted path: numpy} of a JAX or port tree."""
    if isinstance(tree, dict) and tree and all(
            isinstance(v, torch.Tensor) for _, v in flatten_with_paths(tree)):
        return {p: v.detach().float().numpy()
                for p, v in flatten_with_paths(tree)}
    return {p: np.asarray(v, np.float32)
            for p, v in rckpt.flatten_with_paths(tree)}


def _rel_l2(got, want):
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return num / den if den > 0 else num


def _tcfg(mod, **kw):
    base = dict(optim=mod.AdamWConfig(lr_peak=3e-3, warmup_steps=5,
                                      total_steps=60))
    base.update(kw)
    return (step.TrainConfig if mod is adamw else rstep.TrainConfig)(**base)


# ---------------------------------------------------------------------------
# the loss and its gradients, every arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_loss_and_grads_match_the_reference(arch):
    """``jax.value_and_grad(repro.models.api.loss_fn)`` against the port's
    ``loss_fn`` under autograd (remat on in both), at ``REDUCED`` in f32:
    the counterpart of test_models.py::test_arch_smoke_train_step."""
    cfg, rcfg = _cfgs(arch)
    rp = _ref_params(rcfg)
    batch = _batch(rcfg)
    if "labels" in batch:
        batch["labels"][:, ::7] = -1        # ignored labels
    (rtotal, rm), rgrads = ref(jax.jit(lambda p, b: jax.value_and_grad(
        lambda q: rapi.loss_fn(q, rcfg, b), has_aux=True)(p)), rp,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.lm_params(rp, cfg, CPU)
    total, metrics, grads = step.value_and_grad(
        cfg, step.TrainConfig(), params, _torch(batch))
    assert float(total) == pytest.approx(float(rtotal), rel=LOSS_REL)
    assert float(metrics["loss"]) == pytest.approx(float(rm["loss"]),
                                                   rel=LOSS_REL)
    assert float(metrics["aux"]) == pytest.approx(float(rm["aux"]),
                                                  rel=LOSS_REL, abs=1e-7)
    got, want = _leaves(grads), _leaves(rgrads)
    assert set(got) == set(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        if not np.any(want[path]):
            assert not np.any(got[path]), path
        else:
            assert _rel_l2(got[path], want[path]) <= GRAD_REL_L2, path


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-9b",
                                  "qwen2-moe-a2.7b"])
def test_remat_policies_leave_the_gradients_as_they_are(arch):
    """No remat, "full" and "dots" compute the same gradients: the
    recomputation repeats the forward's operations exactly."""
    cfg, rcfg = _cfgs(arch)
    params = convert.lm_params(_ref_params(rcfg), cfg, CPU)
    batch = _torch(_batch(rcfg))
    runs = [step.value_and_grad(cfg, step.TrainConfig(remat=r,
                                                      remat_policy=pol),
                                params, batch)
            for r, pol in ((False, "full"), (True, "full"), (True, "dots"))]
    for total, _, grads in runs[1:]:
        assert torch.equal(total, runs[0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][2])):
            assert torch.equal(a, b)


def test_unknown_remat_policy_is_refused():
    cfg, rcfg = _cfgs("olmo-1b")
    params = api.init_params(0, cfg, CPU)
    with pytest.raises(ValueError, match="remat_policy"):
        step.value_and_grad(cfg, step.TrainConfig(remat_policy="most"),
                            params, _torch(_batch(rcfg)))


def test_train_step_metrics_match_the_reference():
    """One whole train step (loss, grads, AdamW) from the same weights and
    batch: the loss, the gradient norm and the learning rate."""
    cfg, rcfg = _cfgs("olmo-1b")
    rp = _ref_params(rcfg)
    batch = _batch(rcfg)
    _, _, rm = ref(jax.jit(lambda p, b: rstep.make_train_step(
        rcfg, _tcfg(radamw))(p, radamw.init(p), b)), rp,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.lm_params(rp, cfg, CPU)
    _, state, m = step.make_train_step(cfg, _tcfg(adamw))(
        params, adamw.init(params), _torch(batch))
    for k in ("loss", "total", "grad_norm", "lr"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
    assert int(state.count) == 1


# ---------------------------------------------------------------------------
# AdamW and compression
# ---------------------------------------------------------------------------

def _opt_tree(seed, scale=1.0):
    """A small parameter-shaped tree of numpy arrays: 1-D, 2-D and 3-D
    leaves."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"p0_attn": {
        "wq": (scale * rng.standard_normal((2, 6, 3, 4))).astype(np.float32),
        "ln1": (scale * rng.standard_normal((2, 6))).astype(np.float32)}},
        "embed": (scale * rng.standard_normal((9, 6))).astype(np.float32),
        "final_norm": (scale * rng.standard_normal(6)).astype(np.float32)}


def _port(tree):
    return {k: _port(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0, 50.0])
def test_adamw_update_matches_the_reference(grad_scale):
    """Three updates carrying the same gradients into both: the clip
    (grad_scale 50 clips), weight decay on the 2-D and larger leaves, the
    warmup and the bias corrections."""
    cfg = radamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=5)
    pcfg = adamw.AdamWConfig(**cfg.to_dict())
    params = _opt_tree(0)
    rstate = ref(radamw.init, params)
    pparams, pstate = _port(params), convert.adamw_state(rstate, CPU)
    rparams = params
    for i in range(3):
        g = _opt_tree(10 + i, grad_scale)
        rparams, rstate, rm = ref(radamw.update, cfg, g, rstate, rparams)
        pparams, pstate, m = adamw.update(pcfg, _port(g), pstate, pparams)
        for k in ("grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=ADAM_REL)
        for tree, want in ((pparams, rparams), (pstate.mu, rstate.mu),
                           (pstate.nu, rstate.nu)):
            got, exp = _leaves(tree), _leaves(want)
            for p in exp:
                np.testing.assert_allclose(
                    got[p], exp[p], rtol=ADAM_REL,
                    atol=ADAM_REL * float(np.abs(exp[p]).max()))
        assert int(pstate.count) == int(rstate.count) == i + 1


def test_adamw_keeps_bf16_parameters_in_bf16():
    p = {"w": torch.randn(4, 3).to(torch.bfloat16), "b": torch.randn(3)}
    state = adamw.init(p)
    assert all(m.dtype == torch.float32 for m in tree_leaves(state.mu))
    new, state, _ = adamw.update(adamw.AdamWConfig(), p, state, p)
    assert new["w"].dtype == torch.bfloat16 and new["b"].dtype == \
        torch.float32
    assert state.count.dtype == torch.int32


@pytest.mark.parametrize("step_", [0, 1, 50, 99, 100, 101, 5000, 9999,
                                   10_000, 20_000])
def test_cosine_lr_matches_the_reference(step_):
    cfg = radamw.AdamWConfig()
    want = ref(radamw.cosine_lr, cfg, jnp.asarray(step_, jnp.int32))
    got = adamw.cosine_lr(adamw.AdamWConfig(), torch.tensor(step_,
                                                            dtype=torch.int32))
    assert float(got) == pytest.approx(float(want), rel=ADAM_REL)


def test_global_norm_and_clipping():
    g = _opt_tree(4, 10.0)
    want = ref(radamw.global_norm, g)
    got = adamw.global_norm(_port(g))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantizer_with_feedback_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((5, 7)) * 10.0 ** seed).astype(np.float32)
    err = (rng.standard_normal((5, 7)) * 1e-3).astype(np.float32)
    rq = ref(rcompress.quantize, x)
    pq = compress.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.q.numpy(), rq.q)
    assert float(pq.scale) == float(rq.scale)
    np.testing.assert_array_equal(compress.dequantize(pq).numpy(),
                                  ref(rcompress.dequantize, rq))
    (rq2, rerr) = ref(rcompress.quantize_with_feedback, x, err)
    pq2, perr = compress.quantize_with_feedback(torch.from_numpy(x),
                                                torch.from_numpy(err))
    np.testing.assert_array_equal(pq2.q.numpy(), rq2.q)
    np.testing.assert_array_equal(perr.numpy(), rerr)
    tree = _opt_tree(seed)
    etree = ref(rcompress.init_error_tree, tree)
    rdeq, rnew = ref(rcompress.tree_quantize_with_feedback, tree, etree)
    pdeq, pnew = compress.tree_quantize_with_feedback(
        _port(tree), compress.init_error_tree(_port(tree)))
    for got, want in ((pdeq, rdeq), (pnew, rnew)):
        g, w = _leaves(got), _leaves(want)
        for p in w:
            np.testing.assert_array_equal(g[p], w[p])


def test_quantizer_keeps_a_zero_tensor_finite():
    qz = compress.quantize(torch.zeros(4))
    assert float(qz.scale) == pytest.approx(1e-12)
    assert torch.equal(compress.dequantize(qz), torch.zeros(4))


def test_compressed_psum_over_one_rank_matches_the_reference(tmp_path):
    """World size 1 over gloo, through the port's ``("data",)`` mesh: the
    reference's ``compressed_psum`` under a one-member named axis."""
    x = np.random.default_rng(5).standard_normal((6, 5)).astype(np.float32)
    want = ref(lambda a: jax.vmap(lambda y: rcompress.compressed_psum(
        y, "d"), axis_name="d")(a[None])[0], x)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = pmesh.data_mesh(1, "cpu")
        got = compress.compressed_psum(torch.from_numpy(x), mesh)
        np.testing.assert_array_equal(got.numpy(), want)
        got2 = compress.compressed_psum(torch.from_numpy(x))
        np.testing.assert_array_equal(got2.numpy(), want)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# configs, inputs, data
# ---------------------------------------------------------------------------

def test_shape_cells_match_the_reference():
    assert [s.to_dict() for s in pbase.SHAPES] == [
        s.to_dict() for s in rbase.SHAPES]
    assert pbase.get_shape("train_4k") == pbase.SHAPES[0]
    with pytest.raises(KeyError):
        pbase.get_shape("nope")


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_input_specs_match_the_reference(arch, mode):
    cfg = registry.get_config(arch, reduced=True)
    rcfg = rreg.get_config(arch, reduced=True)
    specs = api.input_specs(cfg, pbase.ShapeCell("c", 24, 3, mode))
    want = rapi.input_specs(rcfg, rbase.ShapeCell("c", 24, 3, mode))
    assert list(specs) == list(want)
    for k, s in specs.items():
        assert s.shape == want[k].shape, k
        assert str(s.dtype).replace("torch.", "") == str(want[k].dtype), k
    gen = torch.Generator()
    gen.manual_seed(0)
    inputs = api.concrete_inputs(gen, cfg, pbase.ShapeCell("c", 24, 3, mode),
                                 CPU)
    for k, s in specs.items():
        assert tuple(inputs[k].shape) == s.shape and inputs[k].dtype == \
            s.dtype, k
    for k in ("tokens", "labels"):
        if k in inputs:
            assert 0 <= int(inputs[k].min()) and int(inputs[k].max()) < \
                cfg.vocab
    if "pos" in inputs:
        assert inputs["pos"].tolist() == [23]


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-vl-7b",
                                  "seamless-m4t-medium"])
def test_synthetic_tokens_are_the_references_bitwise(arch):
    cfg, rcfg = _cfgs(arch)
    src = ppipe.SyntheticTokens(cfg, SHAPE, seed=7, host_id=1, n_hosts=2)
    rsrc = rpipe.SyntheticTokens(rcfg, RSHAPE, seed=7, host_id=1, n_hosts=2)
    it, rit = iter(src), iter(rsrc)
    for _ in range(3):
        a, b = next(it), next(rit)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert src.state.to_dict() == rsrc.state.to_dict() == {"step": 3}
    assert ppipe.LoaderState.from_dict({"step": "4"}).step == 4
    with pytest.raises(ValueError):
        ppipe.SyntheticTokens(cfg, SHAPE, n_hosts=3)


def test_prefetch_loader_yields_the_references_batches_in_order():
    """The prefetch thread over a queue of depth 2 that stays full for
    longer than its 0.2 s put timeout: the consumer still gets the
    reference's batches 0, 1, 2, ... (the reference's loader would lose
    the batch it held at each timeout)."""
    cfg, rcfg = _cfgs("olmo-1b")
    rsrc = rpipe.SyntheticTokens(rcfg, RSHAPE, seed=2)
    pl = ppipe.PrefetchLoader(ppipe.SyntheticTokens(cfg, SHAPE, seed=2), 2)
    pl.start()
    try:
        for i in range(5):
            if i == 1:
                time.sleep(0.5)
            np.testing.assert_array_equal(pl.next()["tokens"],
                                          rsrc.batch_at(i)["tokens"])
    finally:
        pl.stop()
    assert pl.state is pl.source.state


def test_split_microbatch_takes_positions3_on_axis_1_and_pos_whole():
    batch = {"embeds": torch.arange(24.).reshape(4, 3, 2),
             "positions3": torch.arange(36).reshape(3, 4, 3),
             "pos": torch.tensor([5])}
    mb = step._split_microbatch(batch, 2, 1)
    assert torch.equal(mb["embeds"], batch["embeds"][2:])
    assert torch.equal(mb["positions3"], batch["positions3"][:, 2:])
    assert torch.equal(mb["pos"], batch["pos"])


# ---------------------------------------------------------------------------
# the activity model, stragglers, the energy ledger
# ---------------------------------------------------------------------------

def test_activity_model_matches_the_reference():
    acts = [(0.3, 0.2, 0.05), (0.1, 0.4, 0.0), (0.0, 0.0, 0.0)]
    model, rmodel = pact.ChipPowerModel(), ract.ChipPowerModel()
    for a in acts:
        p, r = pact.StepActivity(*a), ract.StepActivity(*a)
        assert p.step_time_s == r.step_time_s
        assert p.utilisations() == r.utilisations()
        assert model.step_power_w(*a) == rmodel.step_power_w(*a)
    tl = pact.steps_timeline(pact.StepActivity(*acts[0]), 3, model,
                             gap_s=0.05, t0=1.0)
    rtl = ract.steps_timeline(ract.StepActivity(*acts[0]), 3, rmodel,
                              gap_s=0.05, t0=1.0)
    np.testing.assert_array_equal(tl.edges.numpy(), rtl.edges)
    np.testing.assert_array_equal(tl.powers.numpy(), rtl.powers)
    ph = pact.phase_timeline([pact.StepActivity(*a) for a in acts[:2]])
    rph = ract.phase_timeline([ract.StepActivity(*a) for a in acts[:2]])
    np.testing.assert_array_equal(ph.powers.numpy(), rph.powers)
    assert ph.idle_w == rph.idle_w


def test_straggler_stats_match_the_reference():
    """tests/test_training.py's case, then 260 random step times (past the
    200-step window) through both: the same flags, count and window."""
    st, rst = loop.StragglerStats(), rloop.StragglerStats()
    for _ in range(10):
        assert not st.record(0.1, factor=2.0)
        rst.record(0.1, factor=2.0)
    assert st.record(0.5, factor=2.0) and rst.record(0.5, factor=2.0)
    assert st.n_stragglers == 1
    times = np.random.default_rng(0).exponential(0.1, 260)
    flags = [st.record(float(t), 1.5) for t in times]
    rflags = [rst.record(float(t), 1.5) for t in times]
    assert flags == rflags and any(flags)
    assert st.n_stragglers == rst.n_stragglers and st.times == rst.times


@pytest.fixture
def reference_draws(monkeypatch):
    """A port bank's reading noise is the reference's per-device
    ``default_rng`` stream (``tests/_torch_draws.py``)."""
    _torch_draws.substitute(monkeypatch, _torch_draws.reference_bank)


@pytest.mark.parametrize("profile", ["tpu_v5e_chip", "h100_instant", "a100",
                                     "v100"])
def test_energy_monitor_ledgers_match_the_reference(reference_draws,
                                                    profile):
    lcfg = loop.LoopConfig(sensor_profile=profile, sensor_seed=3)
    rmon = rloop.EnergyMonitor(rloop.LoopConfig(sensor_profile=profile,
                                                sensor_seed=3))
    mon = loop.EnergyMonitor(lcfg, device=CPU)
    mon.sensor = convert.onboard_sensor(rmon.sensor, device=CPU)
    assert dataclasses.asdict(mon.calib) == dataclasses.asdict(rmon.calib)
    for i, wall in enumerate((0.31, 0.05, 1.2, 0.277)):
        mon.record_step(i, wall, util=0.5)
        rmon.record_step(i, wall, util=0.5)
    assert len(mon.ledger.entries) == len(rmon.ledger.entries) == 4
    for e, r in zip(mon.ledger.entries, rmon.ledger.entries):
        assert (e.step, e.t0, e.t1) == (r.step, r.t0, r.t1)
        for f in ("naive_j", "corrected_j", "sigma_j"):
            assert getattr(e, f) == pytest.approx(getattr(r, f),
                                                  rel=LEDGER_REL), f
    assert mon.t == rmon.t
    state = mon.state()
    mon2 = loop.EnergyMonitor(lcfg, device=CPU)
    mon2.load_state(state)
    assert mon2.t == mon.t and mon2.ledger.to_json() == state


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trees(seed):
    params = {"blocks": {"p0_attn": {"wq": torch.randn(2, 3, 4).to(
        torch.bfloat16), "ln1": torch.randn(2, 3)}},
        "embed": torch.randn(5, 3)}
    torch.manual_seed(seed)
    return {"params": params, "opt": adamw.AdamWState(
        torch.tensor(7, dtype=torch.int32),
        {k: v for k, v in adamw.init(params).mu.items()},
        adamw.init(params).nu)}


def test_checkpoint_latest_step_and_restore(tmp_path):
    trees = _trees(0)
    mgr = pckpt.CheckpointManager(str(tmp_path / "ck"), retain=2)
    assert mgr.latest_step() is None
    for s in (3, 6, 9):
        mgr.save_async(s, {n: pckpt.snapshot(t) for n, t in trees.items()},
                       extras={"loader": {"step": s}})
    mgr.wait()
    assert mgr.steps() == [6, 9] and mgr.latest_step() == 9
    got, extras = mgr.restore(9, trees)
    assert extras == {"loader": {"step": 9}}
    assert isinstance(got["opt"], adamw.AdamWState)
    for (p, a), (q, b) in zip(flatten_with_paths(got),
                              flatten_with_paths(trees)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_crosses_both_ways_with_the_reference(tmp_path):
    """The reference reads the port's files and the port the
    reference's: the same paths, shapes and logical types (bf16 as
    ``bfloat16``)."""
    cfg, rcfg = _cfgs("olmo-1b", "bfloat16")
    rp = _ref_params(rcfg)
    rstate = ref(radamw.init, rp)
    params = convert.lm_params(rp, cfg, CPU)
    state = convert.adamw_state(rstate, CPU)
    mgr = pckpt.CheckpointManager(str(tmp_path / "port"))
    mgr.save(4, {"params": pckpt.snapshot(params),
                 "opt": pckpt.snapshot(state)}, extras={"x": 1})
    rgot, rextras = ref(rckpt.CheckpointManager(str(tmp_path / "port"))
                        .restore, 4, {"params": rp, "opt": rstate})
    assert rextras == {"x": 1}
    for got, want in ((rgot["params"], rp), (rgot["opt"].mu, rstate.mu)):
        g, w = _leaves(got), _leaves(want)
        assert set(g) == set(w)
        for p in w:
            np.testing.assert_array_equal(g[p], w[p])
    rmgr = rckpt.CheckpointManager(str(tmp_path / "ref"))
    rmgr.save(5, {"params": rp, "opt": rstate}, extras={"y": 2})
    got, extras = pckpt.CheckpointManager(str(tmp_path / "ref")).restore(
        5, {"params": params, "opt": state})
    assert extras == {"y": 2}
    for (p, a), (q, b) in zip(flatten_with_paths(got),
                              flatten_with_paths({"params": params,
                                                  "opt": state})):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    trees = _trees(1)
    mgr = pckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {n: pckpt.snapshot(t) for n, t in trees.items()})
    bad = dict(trees, params=dict(trees["params"], embed=torch.zeros(6, 3)))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, bad)


def test_adamw_state_converts_the_reference_state():
    rp = _opt_tree(2)
    rstate = ref(radamw.init, rp)
    rstate = rstate._replace(count=np.asarray(4, np.int32))
    st = convert.adamw_state(rstate, CPU)
    assert st.count.dtype == torch.int32 and int(st.count) == 4
    assert set(_leaves(st.mu)) == set(_leaves(rstate.mu))


# ---------------------------------------------------------------------------
# tests/test_training.py's properties, on the port
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg = registry.get_config("olmo-1b", reduced=True)
    out = loop.run_training(cfg, SHAPE, _tcfg(adamw),
                            loop.LoopConfig(total_steps=30, log_every=100),
                            device=CPU)
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 0.1, (first, last)
    assert len(out["grad_norms"]) == len(out["step_s"]) == 30
    assert np.isfinite(out["grad_norms"]).all()


def test_checkpoint_restart_is_exact(tmp_path):
    """20 straight against 10 + restart + 10: the same final loss (the
    data iterator, the optimizer state and the ledger survive)."""
    cfg = registry.get_config("olmo-1b", reduced=True).replace(
        param_dtype="float32")
    tcfg = _tcfg(adamw)
    lc = loop.LoopConfig(total_steps=20, ckpt_every=10, log_every=100)
    straight = loop.run_training(cfg, SHAPE, tcfg, lc, seed=5, device=CPU)
    d = str(tmp_path / "ck")
    loop.run_training(cfg, SHAPE, tcfg, dataclasses.replace(
        lc, total_steps=10), ckpt_dir=d, seed=5, device=CPU)
    resumed = loop.run_training(cfg, SHAPE, tcfg, lc, ckpt_dir=d, seed=5,
                                device=CPU)
    assert len(resumed["losses"]) == 10
    assert resumed["final_loss"] == pytest.approx(straight["final_loss"],
                                                  rel=1e-4)
    assert resumed["energy"]["steps"] == 20


def test_energy_ledger_populated_and_persisted(tmp_path):
    cfg = registry.get_config("olmo-1b", reduced=True)
    out = loop.run_training(cfg, SHAPE, _tcfg(adamw),
                            loop.LoopConfig(total_steps=8, ckpt_every=4,
                                            log_every=100),
                            ckpt_dir=str(tmp_path / "ck"), device=CPU)
    e = out["energy"]
    assert e["steps"] == 8 and e["total_corrected_j"] > 0
    assert pckpt.CheckpointManager(str(tmp_path / "ck")).steps() == [4, 8]


def _one_step(cfg, **kw):
    params = api.init_params(0, cfg, CPU)
    gen = torch.Generator()
    gen.manual_seed(1)
    batch = api.concrete_inputs(gen, cfg, SHAPE, CPU)
    return step.make_train_step(cfg, _tcfg(adamw, **kw))(
        params, adamw.init(params), batch)


def test_microbatch_accumulation_matches_full_batch():
    cfg = registry.get_config("olmo-1b", reduced=True).replace(
        param_dtype="float32")
    p1, _, _ = _one_step(cfg, microbatches=1, remat=False)
    p4, _, _ = _one_step(cfg, microbatches=4, remat=False)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                   atol=2e-4)


def test_compressed_microbatch_grads_close():
    cfg = registry.get_config("olmo-1b", reduced=True).replace(
        param_dtype="float32")
    p1, _, m1 = _one_step(cfg, microbatches=4, remat=False)
    p2, _, m2 = _one_step(cfg, microbatches=4, remat=False,
                          compress_grads=True)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-4)
    num = sum(float(torch.sum((a - b) ** 2))
              for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    den = sum(float(torch.sum(a ** 2)) for a in tree_leaves(p1))
    assert num / den < 1e-4


def test_eval_prefill_and_decode_steps():
    cfg = registry.get_config("olmo-1b", reduced=True).replace(
        param_dtype="float32")
    params = api.init_params(0, cfg, CPU)
    toks = torch.randint(0, cfg.vocab, (2, 9), dtype=torch.int32)
    m = step.make_eval_step(cfg, step.TrainConfig())(params,
                                                     {"tokens": toks})
    with torch.no_grad():
        _, want = api.loss_fn(params, cfg, {"tokens": toks})
    assert torch.equal(m["loss"], want["loss"])
    logits, cache = step.make_prefill_step(cfg, 16)(
        params, {"tokens": toks[:, :8]})
    nxt, _ = step.make_decode_step(cfg)(params, cache, {
        "tokens": toks[:, 8:9], "pos": 8})
    with torch.no_grad():
        full, _ = api.forward(params, cfg, {"tokens": toks})
    np.testing.assert_allclose(nxt[:, 0].numpy(), full[:, 8].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_train_cli_runs_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --reduced --torch-device cpu``
    in a subprocess: the reference's three lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "4", "--seq-len", "16", "--batch", "2",
         "--torch-device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "2"], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["final_loss", "stragglers",
                                                  "energy"]
    assert np.isfinite(float(lines[0].split()[1]))
    assert "'steps': 4" in lines[2]
    assert pckpt.CheckpointManager(str(tmp_path / "ck")).latest_step() == 4
