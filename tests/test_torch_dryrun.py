"""The port's dry run (``python -m repro_torch.launch.dryrun``) against
the JAX package's: the traced dot FLOPs against the reference's
``hlo_dot_flops`` of the same jitted function, the train step against
``FlopCounterMode`` over a real step, the counter's collectives against
``CommDebugMode``, the two custom ops under ``FakeTensorMode``, and the
twins of ``tests/test_dryrun_small.py``'s three tests as subprocesses of
the CLI.

Forward (prefill) and decode counts are exact.  A train step's count is
not the reference's: the port's attention backward is the plain
version's five products (QKᵀ again, dO Vᵀ, dS K, dSᵀ Q, Pᵀ dO, 10 · B ·
Hq · S · T · D), where autodiff of the reference's ``blocked_attention``
takes four (8 · B · Hq · S · T · D at unpadded shapes);
:func:`test_train_flops_are_a_real_steps_and_the_reference_plus_qk` pins
that difference.  Each test that starts placeholder ranks tears its
process group down.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_ref import CPU  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.launch import hlo as rhlo  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import rglru_scan as krs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_process_group, make_mesh  # noqa
from repro_torch.launch.opcount import TraceCounter, count_op  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.layers import blocked_attention  # noqa: E402
from repro_torch.train.step import TrainConfig, make_train_step  # noqa

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ARCHS = ("olmo-1b", "recurrentgemma-9b", "gemma2-2b")
B, S = 2, 256


def _one_rank_trace(arch, mode):
    with fake_process_group(1):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        return dryrun.trace_cell(get_config(arch, reduced=True),
                                 ShapeCell("x", S, B, mode), mesh)


def _ref_hlo_flops(arch, mode):
    """``hlo_dot_flops`` of the reference's jitted forward, serve step or
    train step at the same cell (JAX's CPU device, as the reference's
    dry run lowers it)."""
    from repro.configs.base import ShapeCell as RShape
    from repro.optim import adamw as radamw
    cfg = rreg.get_config(arch, reduced=True)
    shape = RShape("x", S, B, mode)
    pspecs = rapi.param_specs(cfg)
    inputs = rapi.input_specs(cfg, shape)
    if mode == "prefill":
        fn = jax.jit(lambda p, b: rapi.forward(p, cfg, b, remat=True)[0])
        args = (pspecs, inputs)
    elif mode == "decode":
        fn = jax.jit(rstep.make_decode_step(cfg))
        args = (pspecs, rapi.cache_specs(cfg, B, S), inputs)
    else:
        fn = jax.jit(rstep.make_train_step(cfg, rstep.TrainConfig(
            remat=True, remat_policy="full")))
        args = (pspecs, radamw.state_specs(pspecs), inputs)
    with jax.default_device(CPU):
        text = fn.lower(*args).compile().as_text()
    return rhlo.hlo_dot_flops(text)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_dot_flops_are_the_references(arch, mode):
    """A one-rank dry run of the forward and of the serve step counts
    exactly the reference's HLO dot FLOPs."""
    t = _one_rank_trace(arch, mode)
    assert t["counter"].dot_flops == _ref_hlo_flops(arch, mode)
    assert t["counter"].collectives.total_bytes == 0


def test_train_flops_are_a_real_steps_and_the_reference_plus_qk():
    """olmo-1b's train cell (remat "full"): the trace counts what
    ``FlopCounterMode`` counts over one real step on CPU tensors, and
    that is the reference's HLO count plus one QKᵀ a layer (the plain
    backward recomputes the scores, autodiff keeps them): 20/19 of it at
    this shape."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config("olmo-1b", reduced=True)
    traced = _one_rank_trace("olmo-1b", "train")["counter"].dot_flops
    params = api.init_params(0, cfg, "cpu")
    from repro_torch.optim import adamw
    gen = torch.Generator().manual_seed(0)
    batch = api.concrete_inputs(gen, cfg, ShapeCell("x", S, B, "train"),
                                "cpu")
    step = make_train_step(cfg, TrainConfig(remat=True))
    with FlopCounterMode(display=False) as fc:
        step(params, adamw.init(params), batch)
    assert traced == fc.get_total_flops()
    want = _ref_hlo_flops("olmo-1b", "train")
    qk = 2 * B * cfg.n_heads * S * S * cfg.head_dim
    assert traced - want == cfg.n_layers * qk
    assert traced * 19 == want * 20


@pytest.mark.parametrize("mode, passes", [("train", 3), ("prefill", 1)])
def test_compute_term_rates_each_product_by_its_type(mode, passes):
    """The f32 products (the unembedding: forward, and in training the
    two products of its backward) run at the f32 rate, the bf16 ones at
    the tensor cores'; the compute term adds the two."""
    from repro_torch.launch import roofline
    cfg = get_config("olmo-1b", reduced=True)
    t = _one_rank_trace("olmo-1b", mode)
    c = t["counter"]
    f32 = passes * 2 * B * S * cfg.d_model * cfg.vocab
    assert c.dot_flops_by_dtype == {torch.float32: f32,
                                    torch.bfloat16: c.dot_flops - f32}
    r = roofline.analyze(c, cfg, ShapeCell("x", S, B, mode), "one", 1,
                         1.0, 1, 1)
    assert r.compute_s == (c.dot_flops - f32) / 989e12 + f32 / 67e12


@pytest.mark.parametrize("b, s, t, hq, hkv, d, kw", [
    (2, 64, 64, 4, 2, 16, dict(causal=True)),
    (1, 600, 600, 2, 1, 8, dict(causal=True, window=100)),
    (1, 40, 1100, 4, 4, 8, dict(causal=False, softcap=30.0)),
    (3, 515, 70, 2, 2, 8, dict(causal=True, window=8, softcap=5.0))])
def test_attention_flop_formulas_are_the_plain_versions(b, s, t, hq, hkv,
                                                        d, kw):
    """The ops' formulas give what ``FlopCounterMode`` counts over
    ``blocked_attention`` (its blocks padded, masked ones included) and
    over ``flash_attention_bwd_plain``; through the ops it counts the
    formulas."""
    from torch.utils.flop_counter import FlopCounterMode
    rng = np.random.default_rng(s)
    q = torch.from_numpy(rng.standard_normal((b, s, hq, d)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, t, hkv, d)).astype(
        np.float32)) for _ in range(2))
    with FlopCounterMode(display=False) as fc:
        o = blocked_attention(q, k, v, **kw)
    assert fc.get_total_flops() == kfa.forward_flops(q.shape, k.shape)
    with FlopCounterMode(display=False) as fc:
        kfa.flash_attention_bwd_plain(q, k, v, o, o, **kw)
    assert fc.get_total_flops() == kfa.backward_flops(q.shape, k.shape)
    q.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        kfa.flash_attention(q, k, v, **kw).sum().backward()
    assert fc.get_total_flops() == kfa.forward_flops(q.shape, k.shape) + \
        kfa.backward_flops(q.shape, k.shape)


def _trace_ops(device, grad):
    """Both ops forward and backward on fake tensors of ``device``:
    through autograd (``grad``), or the backward ops called as they are."""
    q = torch.empty(2, 40, 4, 16, dtype=torch.bfloat16, device=device,
                    requires_grad=grad)
    k = torch.empty(2, 40, 1, 16, dtype=torch.bfloat16, device=device,
                    requires_grad=grad)
    a = torch.empty(2, 40, 8, device=device, requires_grad=grad)
    u = torch.empty(2, 40, 8, dtype=torch.bfloat16, device=device,
                    requires_grad=grad)
    o = kfa.flash_attention(q, k, k, causal=True, window=8)
    h = krs.rglru_scan(a, u)
    if grad:
        dq, dk, _ = torch.autograd.grad(o.sum(), (q, k, k))
        da, du = torch.autograd.grad(h.float().sum(), (a, u))
        du_type = torch.bfloat16
    else:
        dq, dk, _ = kfa._bwd_op(q, k, k, o, o, True, 8, 0.0)
        da, du = krs._bwd_op(a, h.float(), h.float())
        du_type = torch.float32
    assert (o.shape, o.dtype, o.device.type) == (q.shape, q.dtype, device)
    assert (dq.shape, dk.shape) == (q.shape, k.shape)
    assert (h.shape, h.dtype, h.device.type) == (u.shape, u.dtype, device)
    assert (da.dtype, du.dtype, du.shape) == (torch.float32, du_type,
                                              u.shape)


@pytest.mark.parametrize("device, grad", [("cpu", True), ("cpu", False),
                                          ("cuda", False)])
def test_fake_tensors_trace_both_ops_and_their_backward(monkeypatch,
                                                        device, grad):
    """Under FakeTensorMode both custom ops and their backward ops give
    their outputs' shapes and types on CPU and on fake CUDA tensors: no
    kernel is built, none launched.  (Autograd is not entered on fake
    CUDA tensors: a CPU-only torch has no CUDA device for its engine.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(_build, "load", no_build)
    kfa.reset_launches()
    krs.reset_launches()
    with FakeTensorMode():
        _trace_ops(device, grad)
    assert kfa.flash_attention.launches == 0
    assert kfa.flash_attention_bwd_dq.launches == 0
    assert krs.rglru_scan.launches == krs.rglru_scan_bwd.launches == 0


def test_collectives_are_counted_as_comm_debug_mode_counts_them():
    """A gather, an all-reduce and a reduce-scatter on a fake (2, 2) mesh:
    the counter's counts are ``CommDebugMode``'s, its bytes each
    collective's result."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch.distributed.tensor.debug import CommDebugMode
    funcol = torch.ops.c10d_functional
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(8, 16), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            p = DTensor.from_local(torch.empty(8, 16), mesh,
                                   [Replicate(), Partial()], run_check=False)
            with TraceCounter() as c, CommDebugMode() as cm:
                x.redistribute(mesh, [Replicate(), Replicate()])
                p.redistribute(mesh, [Replicate(), Replicate()])
                p.redistribute(mesh, [Replicate(), Shard(1)])
    counts = cm.get_comm_counts()
    assert c.collectives.count_by_kind == {
        "all-gather": counts[funcol.all_gather_into_tensor],
        "all-reduce": counts[funcol.all_reduce],
        "reduce-scatter": counts[funcol.reduce_scatter_tensor],
        "all-to-all": 0, "collective-permute": 0}
    assert c.collectives.count_by_kind["all-gather"] == 1
    assert c.collectives.bytes_by_kind["all-gather"] == 16 * 16 * 4
    assert c.collectives.bytes_by_kind["all-reduce"] == 8 * 16 * 4
    assert c.collectives.bytes_by_kind["reduce-scatter"] == 8 * 8 * 4


def test_counter_holds_live_bytes_and_their_peak():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(1000)
        c = TraceCounter()
        c.track([a])
        with c:
            b = a * 2
            d = b + 1
            del b
            e = d[:10]
        assert c.peak_bytes == 3 * 4000
        assert c.live_bytes == 2 * 4000        # a and d; e is a view
        assert c.bytes_accessed == 4 * 4000    # a, b, then b, d
        assert (count_op(c, "aten.mul"), count_op(c, "aten.slice")) == (1, 1)
        del e, d
    assert c.live_bytes == 4000


def test_a_failed_cell_is_reported_and_the_sweep_goes_on(monkeypatch,
                                                         capsys, tmp_path):
    real = dryrun.trace_cell

    def flaky(cfg, shape, mesh, **kw):
        if shape.name == "prefill_32k":
            raise RuntimeError("boom")
        return real(cfg, shape, mesh, **kw)
    monkeypatch.setattr(dryrun, "trace_cell", flaky)
    rc = dryrun.main(["--mesh", "tiny", "--reduced", "--arch",
                      "recurrentgemma-9b", "--shape", "prefill_32k",
                      "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1 and "FAIL  recurrentgemma-9b" in out and "boom" in out
    assert "dry-run: 0 ok, 0 skip, 1 fail" in out


# ---------------------------------------------------------------------------
# tests/test_dryrun_small.py's three tests, on the port's CLI
# ---------------------------------------------------------------------------

def _run(args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=500)


def test_dryrun_tiny_mesh_reduced(tmp_path):
    out = str(tmp_path / "art")
    r = _run(["--mesh", "tiny", "--reduced", "--arch", "gemma2-2b",
              "--shape", "train_4k", "--out", out])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout
    files = os.listdir(out)
    assert files == ["gemma2-2b__train_4k__tiny2x2.json"]
    art = json.load(open(os.path.join(out, files[0])))
    assert art["status"] == "ok"
    rl = art["roofline"]
    assert rl["dot_flops_per_device"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert "temp_size_in_bytes" in art["memory_analysis"]
    assert art["memory_analysis"]["peak_size_in_bytes"] == \
        rl["peak_memory_per_device"] > 0


def test_dryrun_decode_and_skip(tmp_path):
    out = str(tmp_path / "art")
    r = _run(["--mesh", "tiny", "--reduced", "--arch", "recurrentgemma-9b",
              "--shape", "long_500k", "--out", out])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout
    r2 = _run(["--mesh", "tiny", "--reduced", "--arch", "llama3-405b",
               "--shape", "long_500k", "--out", out])
    assert r2.returncode == 0
    assert "SKIP" in r2.stdout


def test_dryrun_multipod_tiny():
    """The pod axis shards: a (2,2,2) pod×data×model mesh traces olmo-1b's
    train cell."""
    code = """
from repro_torch.configs.registry import get_config
from repro_torch.configs.base import get_shape
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import fake_process_group, make_mesh
cfg = get_config("olmo-1b", reduced=True)
with fake_process_group(8):
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    t = trace_cell(cfg, get_shape("train_4k"), mesh)
print("MULTIPOD_OK", t["counter"].dot_flops > 0,
      t["counter"].collectives.total_bytes > 0)
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=500)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MULTIPOD_OK True True" in r.stdout


# ---------------------------------------------------------------------------
# a (2, 2) mesh: each rank's dot FLOPs against the reference's dry run
# ---------------------------------------------------------------------------

TINY_CELLS = [(a, s) for a in ARCHS for s in ("prefill_32k", "decode_32k")]

#: the reference's dry run of the tiny cells, on 4 placeholder host
#: devices; besides each artifact's ``dot_flops_per_device`` it splits
#: the HLO's dots into those outside a loop nested in a loop and those
#: inside one (``blocked_attention``'s key-block scan inside its
#: query-block map), each body counted with the trips of every loop
#: around it
REF_TINY = """
import json, os, sys
os.environ["REPRO_DRYRUN_DEVICES"] = "4"
from repro.launch import dryrun, hlo
from repro.launch.mesh import make_mesh
texts = {}
lower = dryrun.lower_cell
def keep(cfg, shape, mesh, **kw):
    out = lower(cfg, shape, mesh, **kw)
    texts[cfg.name, shape.name] = out[1]
    return out
dryrun.lower_cell = keep
def split(text):
    comps = hlo._split_computations(text)
    edges = []
    for name, lines in comps.items():
        for line in lines:
            m = hlo._WHILE_RE.search(line)
            if m:
                trips = hlo._trip_count(comps.get(m.group(1), []))
                edges += [(name, c, trips) for c in m.group(2, 1)]
    mult, depth = dict.fromkeys(comps, 1), dict.fromkeys(comps, 0)
    for _ in comps:
        for parent, child, trips in edges:
            mult[child] = max(mult[child], trips * mult[parent])
            depth[child] = max(depth[child], depth[parent] + 1)
    parts = [0, 0]
    for name, lines in comps.items():
        one = "\\n".join([f"%{name} () -> () {{", *lines, "}"])
        parts[depth[name] >= 2] += mult[name] * int(hlo.hlo_dot_flops(one))
    return parts
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for cell in sys.argv[2:]:
    arch, shape = cell.split(":")
    r = dryrun.run_cell(arch, shape, mesh, "tiny2x2", True, sys.argv[1])
    res = dict(status=r["status"], error=r.get("error"))
    if r["status"] == "ok":
        res["artifact"] = json.load(open(os.path.join(
            sys.argv[1], f"{arch}__{shape}__tiny2x2.json")))["roofline"][
                "dot_flops_per_device"]
        res["outer"], res["nested"] = split(texts[arch, shape])
    out[cell] = res
print("REF_TINY", json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_tiny(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref_tiny"))
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-c", REF_TINY, out,
         *(f"{a}:{s}" for a, s in TINY_CELLS)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=500)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REF_TINY")]
    assert r.returncode == 0 and line, r.stdout + r.stderr
    return json.loads(line[0].split(" ", 1)[1])


def _tiny_trace(arch, shape):
    from repro_torch.configs.base import get_shape
    with fake_process_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        return dryrun.trace_cell(get_config(arch, reduced=True),
                                 get_shape(shape), mesh)["counter"]


def _decode_extra(cfg, batch):
    """The products DTensor runs on the whole ``model`` dim of a weight
    where the reference's run on half of it (each rank's half of the
    batch, a (2, 2) mesh): every layer's MLP gate and up, the q/k/v of
    every layer but the first, and the unembedding.  Each adds its
    reference count once more."""
    b, d = batch // 2, cfg.d_model
    mlp = cfg.n_layers * 2 * (2 * b * d * cfg.d_ff // 2)
    qkv = (cfg.n_layers - 1) * 2 * b * d * (
        cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim // 2
    return mlp + qkv + 2 * b * d * cfg.vocab // 2


@pytest.mark.parametrize("arch, shape", TINY_CELLS)
def test_tiny_mesh_dot_flops_against_the_references_dry_run(ref_tiny, arch,
                                                            shape):
    """Each rank's dot FLOPs on a (2, 2) mesh at ``REDUCED`` against the
    reference's dry run of the same cell on 4 host devices.  Neither is
    equal to the other, for causes outside the port's counting:

    * prefill: the reference's artifact counts a loop nested in a loop
      with its own trips only (``hlo_dot_flops`` multiplies each while
      body in one pass, inner bodies before the loops around them), so
      it undercounts ``blocked_attention``'s key-block scan; counted with
      every loop's trips, its attention is 4 times the port's, because
      GSPMD runs the query-block map on the whole batch on every rank
      where DTensor shards the batch.  The other products agree exactly.
    * decode: the residual stream is feature-sharded, its norm leaves a
      pending partial sum, and DTensor then gathers small weight shards
      (:func:`_decode_extra`); the attention over the cache agrees.
    * recurrentgemma-9b ``decode_32k``: the reference's cell fails (an
      XLA sharding check on the recurrent state's update); the port's
      traces.
    """
    ref = ref_tiny[f"{arch}:{shape}"]
    got = _tiny_trace(arch, shape).dot_flops
    cfg = get_config(arch, reduced=True)
    if arch == "recurrentgemma-9b" and shape == "decode_32k":
        assert ref["status"] == "fail"
        assert "dynamic_update_slice operand sharding" in ref["error"]
        assert got > 0
        return
    assert ref["status"] == "ok"
    if shape == "prefill_32k":
        assert ref["artifact"] < ref["outer"] + ref["nested"]
        assert ref["nested"] % 4 == 0
        assert got == ref["outer"] + ref["nested"] // 4
    else:
        assert ref["nested"] == 0 and ref["artifact"] == ref["outer"]
        assert got == ref["artifact"] + _decode_extra(cfg, 128)
