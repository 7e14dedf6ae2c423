"""The port's sharded fleet audit (``repro_torch.core.fleet_engine_shard``,
``repro_torch.launch.mesh``) on the CPU over gloo, mirroring the cases
of ``tests/test_fleet_shard.py``.

* the Chan tree and the per-rank moment blocks against the reference's
  sequential ``StreamingMoments`` fold of ``numpy_backend.err_moments``
  (rtol 1e-12, atol 1e-15), and against the reference's own
  ``tree_merge_moments`` where it imports;
* at world size 1, in this process: the sharded audit against the
  reference's numpy-tier ``fleet_audit``, its hidden parameters and draws
  carried across as ``test_torch_audit.py`` carries them, at that file's
  tolerances; ``mesh=`` and the entry point and the unsharded audit at
  the same chunking, bitwise;
* at world sizes 2 and 4: one spawn each (``_torch_shard_ranks.py``),
  every case inside the ranks, against the port's unsharded audit.

Each process group comes up through a ``file://`` store under the test's
``tmp_path`` and is destroyed at the end of its test.
"""
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

import _torch_shard_ranks as ranks  # noqa: E402
from test_torch_audit import (AUDIT, E_ATOL, E_RTOL, _carry_fleet,  # noqa: E402,F401
                              _np, _workloads, reference_draws)

from repro.core import fleet_engine as rfe  # noqa: E402
from repro.core.engine_backend import numpy_backend as nb  # noqa: E402
from repro_torch.core import fleet_engine as fe  # noqa: E402
from repro_torch.core import fleet_engine_shard as fes  # noqa: E402
from repro_torch.core import load as ploads  # noqa: E402
from repro_torch.engine_backend import torch_backend as tb  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402

CPU = "cpu"
CUTS = ([0, 257], [0, 1, 257], [0, 40, 40, 100, 256, 257],
        [0, 17, 45, 45, 45, 120, 200, 250, 257])
SPAWN_TIMEOUT_S = 240


def _blocks(e, cuts):
    """The reference's per-partition blocks and its sequential fold."""
    blocks, seq = [], rfe.StreamingMoments()
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        m = nb.err_moments(e[lo:hi])
        blocks.append([float(m[0]), m[1], m[2], m[3], m[4]])
        seq.merge(*m)
    return np.asarray(blocks), seq


def _init_world1(path):
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))


@pytest.fixture
def world1(tmp_path):
    """A gloo group of this process alone and its ``("data",)`` mesh."""
    _init_world1(tmp_path / "pg")
    try:
        yield pmesh.data_mesh(1, "cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the Chan tree and the moment blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cuts", CUTS, ids=[str(len(c) - 1) for c in CUTS])
def test_tree_merge_matches_sequential_fold(cuts):
    """Non-powers of two and empty blocks interleaved."""
    e = np.random.default_rng(7).normal(size=257)
    blocks, seq = _blocks(e, cuts)
    merged = fes.tree_merge_moments(torch.as_tensor(blocks)).numpy()
    assert merged.shape == (5,)
    assert int(merged[0]) == seq.n
    np.testing.assert_allclose(
        merged[1:], [seq.mean, seq.m2, seq.mean_abs, seq.max_abs],
        rtol=1e-12, atol=1e-15)


def test_tree_merge_is_batched_and_empty_blocks_are_identities():
    """A ``[k, B, 5]`` stack merges column by column as ``[k, 5]`` does,
    and a zero block leaves the other side bitwise."""
    e = np.random.default_rng(1).normal(size=257)
    cols = [torch.as_tensor(_blocks(e, [0, 30, 30, 90, 200, 257])[0]),
            torch.as_tensor(_blocks(-e, [0, 100, 101, 180, 256, 257])[0])]
    batched = fes.tree_merge_moments(torch.stack(cols, dim=1))
    for i, col in enumerate(cols):
        assert torch.equal(batched[i], fes.tree_merge_moments(col))
    x = cols[0][:1]
    zero = torch.zeros_like(x)
    assert torch.equal(fes._chan_pair(zero, x), x)
    assert torch.equal(fes._chan_pair(x, zero), x)
    assert torch.equal(fes.tree_merge_moments(x), x[0])


@pytest.mark.parametrize("size", [1, 2, 4, 5 * 4 + 3, 1000])
def test_local_moments_match_numpy(size):
    e = np.random.default_rng(size).normal(scale=0.2, size=size)
    got = fes.local_moments(torch.as_tensor(e)).tolist()
    want = nb.err_moments(e)
    assert int(got[0]) == want[0]
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-12, atol=1e-15)
    # the same ops as the unsharded audit's err_moments: bitwise
    assert got[1:] == list(tb.err_moments(torch.as_tensor(e))[1:])


def test_local_moments_of_no_errors_are_zero():
    got = fes.local_moments(torch.empty(0, dtype=torch.float64))
    assert got.tolist() == [0.0] * 5


def test_reference_tree_merge_where_it_imports():
    """The reference's on-device tree on the same blocks (its module
    needs ``jax.experimental.enable_x64``)."""
    try:
        from repro.core.fleet_engine_shard import tree_merge_moments
    except Exception as exc:  # the reference fails on import, not the port
        pytest.skip(f"the reference's fleet_engine_shard does not import: "
                    f"{exc!r}")
    e = np.random.default_rng(7).normal(size=257)
    for cuts in CUTS:
        blocks, _ = _blocks(e, cuts)
        np.testing.assert_allclose(
            fes.tree_merge_moments(torch.as_tensor(blocks)).numpy(),
            np.asarray(tree_merge_moments(blocks)), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("n, k, chunk", [(102, 4, 100), (102, 2, 50),
                                         (23, 4, 20), (3, 4, 3), (7, 1, 7),
                                         (1, 4, 1)])
def test_shard_rows_cover_each_row_once_in_order(n, k, chunk):
    """Every row of every super-slab goes to one rank, in rank order, in
    parts of ``ceil(rows / k)``; at the end some ranks may have none."""
    rows = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        per = -(-(hi - lo) // k)
        for r in range(k):
            a, b = fes.shard_rows(lo, hi, k, r)
            assert lo <= a <= b <= hi and b - a <= per
            rows.extend(range(a, b))
    assert rows == list(range(n))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_data_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.data_mesh(2, "cpu")


def test_data_mesh_names_a_world_too_small(world1):
    assert world1.mesh_dim_names == ("data",)
    assert pmesh.n_chips(world1) == 1
    with pytest.raises(RuntimeError, match="needs 2 ranks.*has 1"):
        pmesh.data_mesh(2, "cpu")
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        pmesh.data_mesh(0, "cpu")


def test_a_mesh_without_data_is_refused(world1):
    model = pmesh.make_mesh((1,), ("model",), "cpu")
    with pytest.raises(ValueError, match="data_mesh"):
        fe.fleet_audit(3, "a100", mesh=model, device=CPU)
    with pytest.raises(ValueError, match="data_mesh"):
        fes.fleet_audit_sharded(3, "a100", mesh=model, device=CPU)
    with pytest.raises(ValueError, match="differ in length"):
        pmesh.make_mesh((1,), ("data", "model"), "cpu")


def test_mesh_defaults_to_the_card(world1):
    """No entry point runs on the CPU unless asked: without a card the
    default mesh and the default device raise and name the CPU's
    spelling, and a card device on a CPU mesh is refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        pmesh.data_mesh(1)
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        fes.fleet_audit_sharded(3, "a100")
    with pytest.raises(ValueError, match="not of the mesh's device type"):
        fes.fleet_audit_sharded(3, "a100", mesh=world1)


def test_sharded_audit_checks_its_shard_count(world1):
    with pytest.raises(ValueError, match="n_shards=2 but the mesh has 1"):
        fes.fleet_audit_sharded(3, "a100", n_shards=2, mesh=world1,
                                device=CPU)


# ---------------------------------------------------------------------------
# world size 1, in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard_chunk", [16, None])
@pytest.mark.parametrize("per_device", [False, True])
def test_world1_matches_reference(monkeypatch, reference_draws, world1,
                                  per_device, shard_chunk):
    """48 devices of every transient kind and a module-scope row against
    the reference's numpy-tier ``fleet_audit`` at the same chunking."""
    _carry_fleet(monkeypatch, reference_draws)
    names = AUDIT * 6
    n = len(names)
    rwl, pwl = _workloads(n) if per_device else (None, None)
    chunk = n if shard_chunk is None else shard_chunk
    want = rfe.fleet_audit(n, names, workload=rwl, seed=3,
                           good_practice=True, backend="numpy",
                           chunk_devices=chunk)
    got = fes.fleet_audit_sharded(n, names, workload=pwl, seed=3,
                                  good_practice=True, mesh=world1,
                                  shard_chunk=shard_chunk, device=CPU)
    assert got.chunk_devices == chunk
    for key in ("naive_j", "gp_j"):
        np.testing.assert_allclose(_np(getattr(got, key)),
                                   getattr(want, key), rtol=E_RTOL,
                                   atol=E_ATOL, err_msg=key)
    for key in ("naive_err", "gp_err"):
        np.testing.assert_allclose(_np(getattr(got, key)),
                                   getattr(want, key), rtol=0, atol=1e-12,
                                   err_msg=key)
    np.testing.assert_allclose(_np(got.true_j), want.true_j, rtol=1e-12)
    for errs in ("naive_err", "gp_err"):
        g, w = got.stats(getattr(got, errs)), want.stats(getattr(want, errs))
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-9, abs=1e-12), k
    for key in want.streamed:
        w, g = want.streamed[key], got.streamed[key]
        assert set(g["by_scenario"]) == set(w["by_scenario"])
        for label, st in [("overall", w["overall"])] + sorted(
                w["by_scenario"].items()):
            sm = g["overall"] if label == "overall" else g["by_scenario"][
                label]
            assert sm["n_devices"] == st["n_devices"]
            for k in ("mean_err", "mean_abs_err", "std_err", "worst_abs"):
                assert sm[k] == pytest.approx(st[k], rel=1e-9,
                                              abs=1e-12), (key, label, k)
    if per_device:
        np.testing.assert_array_equal(got.scenarios, want.scenarios)


def test_world1_is_the_unsharded_audit_bitwise(world1):
    """At world size 1 the rank's rows are the unsharded slabs: per
    device and in the streamed moments, ``fleet_audit(mesh=)``, the entry
    point and the unsharded audit agree bitwise."""
    n = 4 * 11 + 3
    names = ranks.names(n)
    wls = ploads.FleetScenarioSpec(n, seed=7)
    plain = fe.fleet_audit(n, names, workload=wls, good_practice=True,
                           chunk_devices=12, device=CPU)
    via_mesh = fe.fleet_audit(n, names, workload=wls, good_practice=True,
                              chunk_devices=12, mesh=world1, device=CPU)
    entry = fes.fleet_audit_sharded(n, names, workload=wls,
                                    good_practice=True, mesh=world1,
                                    shard_chunk=12, device=CPU)
    for res in (via_mesh, entry):
        for key in ("naive_j", "gp_j", "naive_err", "gp_err", "true_j"):
            assert torch.equal(getattr(res, key), getattr(plain, key)), key
        np.testing.assert_array_equal(res.scenarios, plain.scenarios)
        assert res.streamed == plain.streamed


def test_world1_streaming_update_through_the_mesh(world1):
    e = torch.as_tensor(np.random.default_rng(3).normal(size=101))
    sm = fe.StreamingMoments().update(e, world1)
    ref = fe.StreamingMoments().update(e)
    assert (sm.n, sm.mean, sm.m2, sm.mean_abs, sm.max_abs) == (
        ref.n, ref.mean, ref.m2, ref.mean_abs, ref.max_abs)


# ---------------------------------------------------------------------------
# world sizes 2 and 4: spawned ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_spawned_ranks_match_the_unsharded_audit(tmp_path, world):
    """Every case of ``_torch_shard_ranks.CASES`` in each of ``world``
    gloo ranks: per device against the unsharded audit at
    ``chunk_devices = shard_chunk`` (bitwise on full super-slabs, 1e-12
    elsewhere), ``stats()``/``by_scenario()``/streamed within 1e-9 rel
    and 1e-12 abs, ``mesh=`` against the entry point and prefetch on
    against off bitwise, ``StreamingMoments.update(e, mesh)``."""
    codes = ranks.spawn(world, tmp_path, SPAWN_TIMEOUT_S)
    assert codes == [0] * world, (
        f"rank exit codes {codes} (None: still running after "
        f"{SPAWN_TIMEOUT_S} s); the failing rank's traceback is in the "
        "captured stderr")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sharded audit on the card runs "
                    "its log_filter kernel, which has no CPU mode "
                    "(chip_smoke.py phase 12 runs it)")
    return torch.device("cuda", 0)


def test_cuda_world1_over_nccl_matches_the_cpu(tmp_path, cuda):
    names = AUDIT * 12
    n = len(names)
    cpu = fe.fleet_audit(n, names, seed=2, good_practice=True,
                         chunk_devices=40, device=CPU)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        card = fes.fleet_audit_sharded(n, names, seed=2, good_practice=True,
                                       mesh=pmesh.data_mesh(1),
                                       shard_chunk=40, device=cuda)
    finally:
        dist.destroy_process_group()
    for key in ("naive_j", "gp_j"):
        np.testing.assert_allclose(_np(getattr(card, key)),
                                   _np(getattr(cpu, key)), rtol=1e-12,
                                   atol=E_ATOL, err_msg=key)
