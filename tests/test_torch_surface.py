"""The port covers the reference's public surface.

Every module of ``src/repro/`` is read as text (``ast``; nothing is
imported), and each public top-level name (a function, a class or an
assignment whose name does not start with ``_``, and every entry of the
module's ``__all__``) must have one of:

* a counterpart of the same name in the port's module at the same path
  (``core/engine_backend/*`` maps to ``engine_backend/*``, and the numpy
  tier ``numpy_backend.py`` to the plain versions in ``torch_backend.py``);
* an entry in :data:`RENAMES`, whose new name the port's module has;
* an entry in :data:`OMITTED`, with the reason it stays the reference's
  (ROADMAP's "Left out of the port on purpose" says the same).

Every reference example has a twin under ``examples/torch/``, and every
script under ``tools/`` is the port's own, has a ``torch_`` twin, or is
listed in :data:`TOOLS_OMITTED`.  The names that only this check asked
for are held against the reference's: the tree helpers on olmo-1b's
``REDUCED`` parameters carried by ``convert.lm_params``,
``rglru_init_state``, ``transformer.init_cache`` and
``validate_positive``.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_jax_ref import ref  # noqa: E402
from repro.common import config as rconfig  # noqa: E402
from repro.common import tree as rtree  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.models import recurrent as rrec  # noqa: E402
from repro.models import transformer as rtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.common import config as pconfig  # noqa: E402
from repro_torch.common import tree as ptree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.ground_truth import MeterConfig  # noqa: E402
from repro_torch.models import api, recurrent, transformer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

#: reference module -> the port's module of another path
MODULE_MAP = {"core/engine_backend/numpy_backend.py":
              "engine_backend/torch_backend.py"}

#: (reference module, name) -> the port's name in the mapped module
RENAMES = {
    ("distributed/sharding.py", "tree_shardings"): "tree_placements",
    ("launch/dryrun.py", "lower_cell"): "trace_cell",
    ("launch/roofline.py", "ICI_BW"): "COLL_BW",
    ("models/moe.py", "CAPACITY_ROUND"): "CAPACITY_MULTIPLE",
}

_REGISTRY = ("the backend registry: the port has one tier, the tensors' "
             "device choosing kernel or plain version")
_LOGGER = ("the reference's common/logging logger; the port's modules log "
           "through stdlib logging")
#: reference module, or (module, name) -> why it stays the reference's
OMITTED = {
    "kernels/ops.py": "the reference's dispatching wrapper: the port's "
                      "entry points are the functions of "
                      "repro_torch.kernels.*",
    "kernels/ref.py": "the reference's oracles: each port kernel has its "
                      "plain version beside it",
    "common/logging.py": _LOGGER,
    "core/engine_backend/vecrng.py": "the reference's PCG64 streams: the "
                                     "port draws from its keyed Philox "
                                     "stream (engine_backend/keyed_rng.py)",
    "core/engine_backend/_ziggurat.py": "the tables of the reference's "
                                        "PCG64 normal and exponential "
                                        "draws (vecrng.py)",
    "core/engine_backend/jax_backend.py": "the jax tier: one tier in the "
                                          "port (torch_backend.py's plain "
                                          "versions and kernels/)",
    "core/engine_backend/pallas_backend.py": "the Pallas tier: its kernels "
                                             "are repro_torch.kernels.*",
    "launch/hlo.py": "parses XLA's compiled HLO; the port's dry run counts "
                     "the traced ops (launch/opcount.py)",
    ("core/engine_backend/__init__.py", "available_backends"): _REGISTRY,
    ("core/engine_backend/__init__.py", "get_backend"): _REGISTRY,
    ("core/engine_backend/__init__.py", "has_jax"): _REGISTRY,
    ("core/engine_backend/__init__.py", "resolve_backend"): _REGISTRY,
    ("core/engine_backend/__init__.py", "numpy_backend"): _REGISTRY,
    ("core/engine_backend/numpy_backend.py", "name"): _REGISTRY,
    ("core/__init__.py", "available_backends"): _REGISTRY,
    ("core/__init__.py", "get_backend"): _REGISTRY,
    ("core/__init__.py", "resolve_backend"): _REGISTRY,
    ("core/fleet_engine_shard.py", "ShardedBackend"):
        "the kernel surface under shard_map: a rank calls the port's "
        "kernels directly",
    ("kernels/flash_attention.py", "NEG_INF"):
        "the Pallas kernel's mask value: the CUDA kernels and the plain "
        "version mask with -inf",
    ("ckpt/checkpoint.py", "log"): _LOGGER,
    ("serve/engine.py", "log"): _LOGGER,
}

#: scripts under tools/ that stay the reference's, and why
TOOLS_OMITTED = {
    "make_profile_table.py": "rewrites docs/sensor-model.md's Fig. 14 "
                             "table from the profiles, which the port "
                             "copies",
    "gen_vecrng_tables.py": "generates _ziggurat.py's tables for the "
                            "reference's PCG64 streams",
    "gen_collect_fixture.py": "writes the collector's test fixtures under "
                              "tests/data, which both packages' tests read",
    "bench_guard.py": "guards the outputs of the reference's benchmarks "
                      "against their baselines; the port has no "
                      "benchmark yet",
    "make_roofline_table.py": "imports neither package: it tabulates the "
                              "dry run's JSON artifacts, which the port "
                              "writes in the reference's layout",
}
#: the port's own tools (``tests/test_torch_guard.py`` checks their
#: imports, and those of the ``torch_`` twins)
PORT_TOOLS = ("kernel_split.py", "rglru_bwd_sweep.py", "span_report.py")


def _modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _public(path):
    """The module's public top-level names and its ``__all__``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        if n.id == "__all__":
                            names.update(ast.literal_eval(node.value))
                        else:
                            names.add(n.id)
    return {n for n in names if not n.startswith("_")}


def _bound(path):
    """Every name the module binds at any level of its body: definitions,
    assignments and imports (a re-export is a counterpart)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def _port_path(rel):
    rel = MODULE_MAP.get(rel, rel)
    if rel.startswith("core/engine_backend/"):
        rel = rel[len("core/"):]
    return PORT / rel


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_counterpart(rel):
    if rel in OMITTED:
        assert OMITTED[rel]
        return
    port = _port_path(rel)
    assert port.exists(), f"no port module for {rel} ({port})"
    have = _bound(port)
    missing = []
    for name in sorted(_public(REF / rel)):
        if (rel, name) in OMITTED:
            continue
        if RENAMES.get((rel, name), name) not in have:
            missing.append(RENAMES.get((rel, name), name))
    assert not missing, f"{rel}: no counterpart for {missing}"


def test_the_tables_name_only_what_exists():
    """Each rename and omission names a module and a public name the
    reference has, and each rename's old name is gone from the port."""
    public = {rel: _public(REF / rel) for rel in _modules()}
    for key in OMITTED:
        rel, name = key if isinstance(key, tuple) else (key, None)
        assert rel in public, key
        assert name is None or name in public[rel], key
    for (rel, old), new in RENAMES.items():
        assert old in public[rel], (rel, old)
        assert old not in _bound(_port_path(rel)), (rel, old)


def test_every_reference_example_has_a_twin():
    want = sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    got = sorted(p.name for p in (ROOT / "examples" / "torch").glob("*.py"))
    assert want and got == want


def _imports_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        if set(roots) & {"jax", "repro"}:
            return True
    return False


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "tools").glob("*.py")))
def test_every_tool_is_ported_or_left_out_with_a_reason(name):
    if name.startswith("torch_") or name in PORT_TOOLS:
        assert not _imports_reference(ROOT / "tools" / name), name
    else:
        assert (ROOT / "tools" / f"torch_{name}").exists() \
            or TOOLS_OMITTED.get(name), name


# ---------------------------------------------------------------------------
# the names this check asked for, against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmo():
    rcfg = rreg.get_config("olmo-1b", reduced=True)
    cfg = registry.get_config("olmo-1b", reduced=True)
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))
    return rp, convert.lm_params(rp, cfg, "cpu")


def test_tree_bytes_and_param_count_equal_the_reference(olmo):
    rp, p = olmo
    assert ptree.tree_bytes(p) == rtree.tree_bytes(rp) > 0
    assert ptree.tree_param_count(p) == rtree.tree_param_count(rp) > 0


def test_tree_as_dict_equals_the_reference(olmo):
    rp, p = olmo
    got, want = ptree.tree_as_dict(p), rtree.tree_as_dict(rp)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k],
                                                         np.float32), k)


def test_tree_helpers_on_named_tuples_and_specs():
    st = recurrent.rglru_init_state(2, 8, 4, device="cpu")
    assert ptree.tree_as_dict({"s": st}).keys() == {"s.h", "s.conv"}
    assert ptree.path_str(("blocks", "p0_attn", 3)) == "blocks.p0_attn.3"
    specs = api.param_specs(registry.get_config("olmo-1b", reduced=True))
    params = api.init_params(0, registry.get_config("olmo-1b",
                                                    reduced=True), "cpu")
    assert ptree.tree_bytes(specs) == ptree.tree_bytes(params)
    assert ptree.tree_param_count(specs) == ptree.tree_param_count(params)
    ptree.assert_trees_all_close(params, params)
    other = ptree.tree_map(lambda x: x + 1, params)
    with pytest.raises(AssertionError):
        ptree.assert_trees_all_close(params, other)


def test_rglru_init_state_matches_the_reference():
    want = rrec.rglru_init_state(3, 16, 4)
    got = recurrent.rglru_init_state(3, 16, 4, device="cpu")
    assert isinstance(got, recurrent.RGLRUState)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert not g.any()
    bf = recurrent.rglru_init_state(1, 8, 2, torch.bfloat16, "cpu")
    assert bf.h.dtype == bf.conv.dtype == torch.bfloat16
    assert tuple(bf.conv.shape) == (1, 1, 8)


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-9b"])
def test_transformer_init_cache_is_api_init_cache(arch):
    cfg = registry.get_config(arch, reduced=True)
    got = ptree.flatten_with_paths(transformer.init_cache(cfg, 2, 16, "cpu"))
    want = ptree.flatten_with_paths(api.init_cache(cfg, 2, 16, "cpu"))
    ref_cache = rtf.init_cache(rreg.get_config(arch, reduced=True), 2, 16)
    ref_shapes = [(k, tuple(v.shape)) for k, v in
                  rtree.flatten_with_paths(ref_cache)]
    assert [(k, tuple(v.shape)) for k, v in got] == ref_shapes
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_validate_positive_raises_as_the_reference():
    for fn in (pconfig.validate_positive, rconfig.validate_positive):
        fn("x", 1.0)
    with pytest.raises(ValueError) as want:
        rconfig.validate_positive("lr", 0)
    with pytest.raises(ValueError) as got:
        pconfig.validate_positive("lr", 0)
    assert str(got.value) == str(want.value) == "lr must be positive, got 0"


def test_meter_config_is_a_config():
    assert issubclass(MeterConfig, pconfig.Config)
    assert MeterConfig().to_dict() == {}
