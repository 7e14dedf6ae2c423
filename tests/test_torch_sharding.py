"""The dry run's specs against the JAX package's: ``sub_quadratic`` and
``cell_applicable``, the sharding rules (``repro_torch.distributed
.sharding`` against ``repro.distributed.sharding``), ``adamw
.state_specs``, ``pick_layout``, the roofline's ``model_flops_for`` and
``analytic_traffic``, the activation constraints and the MoE layer's
grouped dispatch.

The sharding rules are checked on every parameter, input and cache leaf
of every arch's full config, under both layouts, with and without
``replicate_batch``, at the production meshes' axis sizes ({data 16,
model 16} and {pod 2, data 16, model 16}), set on the rules as the
reference's own test sets them (``tests/test_dryrun_small.py:88``).
Specs are compared as tuples: the reference's ``PartitionSpec`` writes
a lone axis as its name, and so does the port.  Every comparison is
exact.  Tests that need placeholder ranks start a ``"fake"`` process
group of their own and tear it down (``fake_process_group``).
"""
import contextlib
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from _torch_jax_ref import ref  # noqa: E402
from repro.configs import base as rbase  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.distributed import act_shard as ract  # noqa: E402
from repro.distributed import sharding as rsh  # noqa: E402
from repro.launch import roofline as rroof  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import act_shard, sharding  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import (fake_process_group, make_mesh,  # noqa
                                     make_production_mesh)
from repro_torch.models import api, moe  # noqa: E402
from repro_torch.models.transformer import leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SIZES = {"pod16x16": {"data": 16, "model": 16},
         "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
SHAPE_NAMES = [s.name for s in base.SHAPES]
MOE_TOL = dict(rtol=1e-5, atol=1e-5)      # tests/test_torch_moe.py's TOL


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dryrun module.  Importing it sets ``XLA_FLAGS`` for
    the process (it forces 512 host devices for a later JAX start); the
    variable is put back so that no later subprocess of this worker sees
    it."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as rdry
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return rdry


def _ref_rules(mesh_name, **kw):
    names = tuple(SIZES[mesh_name])
    devs = np.asarray(jax.devices("cpu")[:1]).reshape((1,) * len(names))
    rules = rsh.ShardingRules(jax.sharding.Mesh(devs, names), **kw)
    rules.axis_sizes = dict(SIZES[mesh_name])
    return rules


def _port_rules(mesh_name, **kw):
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(SIZES[mesh_name]),
                                 shape=tuple(SIZES[mesh_name].values()))
    return sharding.ShardingRules(mesh, **kw)


def _ref_leaves(tree):
    from repro.common.tree import path_str
    return [(path_str(p), tuple(x.shape)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_leaves(tree):
    return [(".".join(map(str, p)), tuple(s.shape)) for p, s in leaves(tree)]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_applicable_matches_the_reference(arch, shape):
    cfg, rcfg = get_config(arch), rreg.get_config(arch)
    assert cfg.sub_quadratic == rcfg.sub_quadratic
    got = base.cell_applicable(cfg, base.get_shape(shape))
    assert got == rbase.cell_applicable(rcfg, rbase.get_shape(shape))


def test_long_500k_applicability():
    """tests/test_models.py::test_long_500k_applicability on the port."""
    long = base.get_shape("long_500k")
    runs = {a: base.cell_applicable(get_config(a), long)[0]
            for a in ARCH_IDS}
    assert runs["xlstm-125m"] and runs["recurrentgemma-9b"]
    assert not runs["llama3-405b"] and not runs["gemma2-2b"]
    assert sum(runs.values()) == 2


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("replicate_batch", [False, True])
@pytest.mark.parametrize("layout", ["default", "fsdp_only"])
@pytest.mark.parametrize("mesh_name", list(SIZES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_input_specs_match_the_reference(arch, mesh_name, layout,
                                                   replicate_batch):
    """Every parameter leaf's spec, every input's at every shape cell,
    and the skipped shardings, in order."""
    kw = dict(layout=layout, replicate_batch=replicate_batch)
    rules, rrules = _port_rules(mesh_name, **kw), _ref_rules(mesh_name, **kw)
    cfg, rcfg = get_config(arch), rreg.get_config(arch)
    got = _port_leaves(api.param_specs(cfg))
    assert got == _ref_leaves(rapi.param_specs(rcfg))
    for path, shape in got:
        assert rules.param_pspec(path, shape) == tuple(
            rrules.param_pspec(path, shape)), path
    assert rules.skipped == rrules.skipped
    assert rules.batch_axes == rrules.batch_axes
    for s in SHAPE_NAMES:
        specs = api.input_specs(cfg, base.get_shape(s))
        rspecs = rapi.input_specs(rcfg, rbase.get_shape(s))
        assert sorted(specs) == sorted(rspecs)
        for name, spec in specs.items():
            assert rules.input_pspec(name, spec.shape) == tuple(
                rrules.input_pspec(name, rspecs[name].shape)), (s, name)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("layout", ["default", "fsdp_only"])
@pytest.mark.parametrize("mesh_name", list(SIZES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_the_reference(arch, mesh_name, layout, shape):
    rules = _port_rules(mesh_name, layout=layout)
    rrules = _ref_rules(mesh_name, layout=layout)
    cell = base.get_shape(shape)
    cache = api.cache_specs(get_config(arch), cell.global_batch,
                            cell.seq_len)
    got = _port_leaves(cache)
    assert got == _ref_leaves(rapi.cache_specs(
        rreg.get_config(arch), cell.global_batch, cell.seq_len))
    for path, s in got:
        assert rules.cache_pspec(path, s) == tuple(
            rrules.cache_pspec(path, s)), path


def test_rules_never_shard_a_dim_that_does_not_divide():
    """tests/test_dryrun_small.py::test_sharding_rules_divisibility on the
    port: recurrentgemma's one KV head is not padded 16×."""
    rules = _port_rules("pod16x16")
    assert rules.param_pspec("blocks.p2_attn.wk", (38, 4096, 1, 256))[2] \
        is None
    assert rules.param_pspec("blocks.p0_attn.wq",
                             (36, 4096, 32, 128))[2] == "model"
    assert rules.param_pspec("embed", (49155, 1536))[0] is None
    assert rules.param_pspec("embed", (256000, 2304))[0] == "model"


def test_tree_pspecs_and_placements_on_a_production_mesh():
    """The rules read a real mesh's axes; a tuple of axes on one dim
    shards it on each, in mesh order, and every other mesh dim
    replicates."""
    from torch.distributed.tensor import Replicate, Shard
    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        rules = sharding.ShardingRules(mesh)
        assert rules.axis_sizes == SIZES["pod2x16x16"]
        assert sharding.to_placements((("pod", "data"), None, "model"),
                                      mesh) == (Shard(0), Shard(0), Shard(2))
        assert sharding.to_placements((), mesh) == (Replicate(),) * 3
        cfg = get_config("llama3-405b")
        specs = sharding.tree_pspecs(rules, api.param_specs(cfg), "params")
        assert specs["blocks"]["p0_attn"]["wq"] == (None, "data", "model",
                                                    None)
        places = sharding.tree_placements(rules, api.param_specs(cfg),
                                          "params")
        assert places["blocks"]["p0_attn"]["wq"] == (Replicate(), Shard(1),
                                                     Shard(2))
    with fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        assert (tuple(mesh.shape), mesh.mesh_dim_names) == (
            (16, 16), ("data", "model"))


def test_fake_process_group_is_torn_down():
    import torch.distributed as dist
    with fake_process_group(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_process_group(2):
                pass
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_match_the_reference(arch):
    got = adamw.state_specs(api.param_specs(get_config(arch)))
    want = radamw.state_specs(rapi.param_specs(rreg.get_config(arch)))
    assert got.count.shape == () and got.count.dtype == torch.int32
    assert want.count.shape == () and want.count.dtype == jnp.int32
    for mine, theirs in ((got.mu, want.mu), (got.nu, want.nu)):
        assert _port_leaves(mine) == _ref_leaves(theirs)
        assert {s.dtype for _, s in leaves(mine)} == {torch.float32}
        assert {x.dtype for x in jax.tree_util.tree_leaves(theirs)} == {
            jnp.dtype(jnp.float32)}


# ---------------------------------------------------------------------------
# layout, model FLOPs and the traffic model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pick_layout_matches_the_reference(ref_dryrun, arch, chips):
    cfg, rcfg = get_config(arch), rreg.get_config(arch)
    for s in SHAPE_NAMES:
        assert dryrun.pick_layout(cfg, base.get_shape(s), chips) == \
            ref_dryrun.pick_layout(rcfg, rbase.get_shape(s), chips), s


def _ref_counts(ref_dryrun, rcfg):
    """(total, active) parameters as the reference's dry run takes them."""
    if not rcfg.encdec:
        return rtf.param_count(rcfg), rtf.active_param_count(rcfg)
    total = sum(int(np.prod(x.shape)) for x in
                jax.tree_util.tree_leaves(rapi.param_specs(rcfg)))
    return total, ref_dryrun._encdec_active(rcfg)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_traffic_match_the_reference(ref_dryrun, arch):
    cfg, rcfg = get_config(arch), rreg.get_config(arch)
    total, active = dryrun._total_params(cfg), dryrun._active_params(cfg)
    assert (total, active) == _ref_counts(ref_dryrun, rcfg)
    for s in SHAPE_NAMES:
        shape, rshape = base.get_shape(s), rbase.get_shape(s)
        assert roofline.model_flops_for(cfg, shape, active) == \
            rroof.model_flops_for(rcfg, rshape, active)
        for chips in (4, 256, 512):
            assert roofline.analytic_traffic(
                cfg, shape, chips, total, active) == rroof.analytic_traffic(
                    rcfg, rshape, chips, total, active), (s, chips)


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.F32_FLOPS, roofline.HBM_BW,
            roofline.HBM_PER_CHIP, roofline.COLL_BW) == (
                989e12, 67e12, 3.35e12, 80e9, 50e9)


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fake_mesh():
    """A (2, 2) mesh over four placeholder ranks, under FakeTensorMode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with FakeTensorMode():
            yield mesh


KINDS = {"bsd": (8, 4, 16), "bsf": (8, 4, 32), "bshe": (8, 4, 6, 16),
         "bsv": (8, 4, 64), "gecd": (4, 16, 8, 16), "gecf": (4, 16, 8, 32),
         "gtd": (4, 8, 16)}


def test_constrain_is_the_identity_without_a_context():
    from torch.distributed.tensor import DTensor, Replicate
    x = torch.ones(8, 4, 16)
    assert act_shard.constrain(x, "bsd") is x
    with act_shard.activation_sharding(("data",), "model", 2,
                                       batch_size=2):
        assert act_shard.constrain(x, "bsd") is x      # a plain tensor
    with _fake_mesh() as mesh:
        d = DTensor.from_local(torch.empty(8, 4, 16), mesh,
                               [Replicate(), Replicate()], run_check=False)
        assert act_shard.constrain(d, "bsd") is d
        assert act_shard.gather_weights({"w": d})["w"] is d


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_constrain_places_each_kind(mode):
    """On a fake (2, 2) mesh: each kind's placements are its spec's, the
    reference's constraint spec written as DTensor placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    R, S = Replicate(), Shard
    b = S(0) if mode == "train" else R
    want = {"bsd": (S(0), R) if mode == "train" else (S(2), R),
            "bsf": (b, S(2)), "bshe": (b, S(2)), "bsv": (b, S(2)),
            "gecd": (b, R), "gecf": (b, S(3)), "gtd": (b, R)}
    with _fake_mesh() as mesh:
        batch = ("data",) if mode == "train" else ()
        with act_shard.activation_sharding(
                batch, "model", 2, batch_size=2, fsdp_axis="data",
                fsdp_size=2, mode=mode):
            for kind, shape in KINDS.items():
                x = DTensor.from_local(torch.empty(shape), mesh, [R, R],
                                       run_check=False)
                y = act_shard.constrain(x, kind)
                assert tuple(y.placements) == want[kind], kind
                assert tuple(y.shape) == shape
                assert act_shard.spec_for(shape, kind) == _ref_spec(
                    kind, shape, batch, mode), kind


def _ref_spec(kind, shape, batch, mode):
    """The spec the reference's ``constrain`` pins for ``kind`` (its
    ``with_sharding_constraint`` argument), under the same context."""
    seen = []
    real = ract.jax.lax.with_sharding_constraint
    ract.jax.lax.with_sharding_constraint = lambda x, s: seen.append(s) or x
    try:
        with ract.activation_sharding(batch, "model", 2, batch_size=2,
                                      fsdp_axis="data", fsdp_size=2,
                                      mode=mode):
            ract.constrain(jnp.zeros(shape), kind)
    finally:
        ract.jax.lax.with_sharding_constraint = real
    return tuple(seen[0])


def test_gather_weights_replicates_the_fsdp_shards():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with _fake_mesh() as mesh:
        w = DTensor.from_local(torch.empty(8, 4), mesh, [Shard(0), Shard(1)],
                               run_check=False)
        with act_shard.activation_sharding(("data",), "model", 2,
                                           gather_axes=("data",)):
            got = act_shard.gather_weights({"a": {"w": w}})["a"]["w"]
        assert tuple(got.placements) == (Replicate(), Shard(1))
        with act_shard.activation_sharding((), "model", 2, mode="decode",
                                           gather_axes=("data",)):
            assert act_shard.gather_weights(w) is w


# ---------------------------------------------------------------------------
# the MoE layer's grouped dispatch
# ---------------------------------------------------------------------------

def _ref_group_dispatch(x, router, k, Ep, cf, G):
    """The reference's grouped routing (``moe.py:57-84``): the top-k
    experts [T, k] and the kept mask [T, k] of G groups."""
    T = x.shape[0] * x.shape[1]
    Tg = T // G
    cap = int(max(1, (k * Tg * cf) // Ep))
    cap = -(-cap // 128) * 128

    def run():
        logits = jnp.einsum("td,de->te", jnp.asarray(x).reshape(T, -1),
                            jnp.asarray(router),
                            preferred_element_type=jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        _, topi = jax.lax.top_k(probs, k)
        flat = topi.reshape(G, Tg * k)
        onehot = jax.nn.one_hot(flat, Ep, dtype=jnp.int32)
        pos = jnp.take_along_axis(jnp.cumsum(onehot, 1) - onehot,
                                  flat[..., None], axis=2)[..., 0]
        return probs, topi, (pos < cap).reshape(T, k)
    return ref(run)


@pytest.mark.parametrize("cf", [4.0, 0.02])
@pytest.mark.parametrize("groups", [2, 4])
def test_moe_grouped_dispatch_matches_the_reference(groups, cf):
    """G capacity slices, each its own slots: routing bitwise, y at
    tests/test_torch_moe.py's tolerance; at cf 4 every assignment is kept,
    at cf 0.02 each group's 128 slots an expert overflow and drop some."""
    E, Ep, k, D, F = 8, 16, 2, 32, 48
    rng = np.random.default_rng(groups)
    p = {"router": rng.standard_normal((D, E)).astype(np.float32) * 0.3,
         "w_gate": rng.standard_normal((Ep, D, F)).astype(np.float32) * 0.1,
         "w_up": rng.standard_normal((Ep, D, F)).astype(np.float32) * 0.1,
         "w_down": rng.standard_normal((Ep, F, D)).astype(np.float32) * 0.1}
    x = rng.standard_normal((4, 640, D)).astype(np.float32)
    with act_shard.activation_sharding(("data",), "", 1, batch_size=groups):
        assert act_shard.batch_groups() == groups
        with moe.record_dispatch() as rec:
            y, aux = moe.moe_ffn(torch.from_numpy(x),
                                 {n: torch.from_numpy(v)
                                  for n, v in p.items()},
                                 n_experts=E, top_k=k, capacity_factor=cf)
    with ract.activation_sharding(("data",), "", 1, batch_size=groups):
        want_y, want_aux = ref(rmoe.moe_ffn, x, p, n_experts=E, top_k=k,
                               capacity_factor=cf)
        _, topi, keep = _ref_group_dispatch(x, p["router"], k, Ep, cf,
                                            groups)
    np.testing.assert_array_equal(rec[0].topi.numpy(), topi)
    np.testing.assert_array_equal(rec[0].keep.numpy(), keep)
    assert (cf < 1) == (not keep.all())
    np.testing.assert_allclose(y.numpy(), want_y, **MOE_TOL)
    np.testing.assert_allclose(float(aux), want_aux, **MOE_TOL)
