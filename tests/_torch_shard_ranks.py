"""Rank processes for ``tests/test_torch_shard.py``: the sharded fleet
audit at world sizes above 1, on the CPU over gloo.

:func:`spawn` starts ``world`` processes (``spawn`` context), each of
which joins a gloo group through a ``file://`` store under the test's
``tmp_path`` (so concurrent test workers never share a port), runs
:func:`cases` and leaves the group.  A case that fails raises in its
rank, whose traceback goes to the test's captured stderr and whose exit
code fails the test; a rank that hangs is ended at its timeout.
"""
import datetime
import multiprocessing
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import fleet_engine as fe
from repro_torch.core import load as loads
from repro_torch.core.fleet_engine_shard import (fleet_audit_sharded,
                                                 shard_rows)
from repro_torch.launch.mesh import data_mesh

CPU = "cpu"
# every transient kind: boxcar windows, the Kepler/Maxwell filter
# (log_filter), the Fermi model estimate
PROFILES = ["a100", "h100_instant", "v100", "rtx3090_530", "kepler",
            "maxwell", "fermi2"]
SHARD_CHUNK = 25
N_SPEC = 25 * 4 + 2          # never a multiple of the mesh
N_SHARED = 4 * 5 + 3
COLLECTIVE_TIMEOUT_S = 60


def names(n):
    return [PROFILES[i % len(PROFILES)] for i in range(n)]


def _close(got, want, what, rtol=1e-12, atol=0.0):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol, err_msg=what)


def _equal(got, want, what):
    assert torch.equal(got, want), what


def _stats_close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12,
                                   err_msg=f"{what} {k}")


def _streamed_close(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        _stats_close(got[key]["overall"], want[key]["overall"],
                     f"{what} {key} overall")
        assert (set(got[key]["by_scenario"])
                == set(want[key]["by_scenario"])), what
        for label, st in want[key]["by_scenario"].items():
            _stats_close(got[key]["by_scenario"][label], st,
                         f"{what} {key} {label}")


def _per_device(sh, ref, world, what):
    """Per device against the unsharded audit at ``chunk_devices =
    shard_chunk``: bitwise on the full super-slabs, whose rank parts are
    the unsharded slabs; 1e-12 relative elsewhere (energies), 1e-12
    absolute on the relative errors."""
    full = (sh.n_devices // (world * SHARD_CHUNK)) * world * SHARD_CHUNK
    for key in ("naive_j", "gp_j", "naive_err", "gp_err"):
        got, want = getattr(sh, key), getattr(ref, key)
        if got is None:
            assert want is None, key
            continue
        _equal(got[:full], want[:full], f"{what}: {key} on full super-slabs")
        if key.endswith("_j"):
            _close(got, want, f"{what}: {key}")
        else:
            _close(got, want, f"{what}: {key}", rtol=0.0, atol=1e-12)


def case_spec(world, rank, mesh):
    """A FleetScenarioSpec of 25 * 4 + 2 devices with §5: per device, the
    exact and streamed statistics, ``mesh=`` against the entry point and
    prefetch on against off."""
    n = N_SPEC
    spec = loads.FleetScenarioSpec(n, seed=7)
    ref = fe.fleet_audit(n, names(n), workload=spec, good_practice=True,
                         chunk_devices=SHARD_CHUNK, device=CPU)
    sh = fleet_audit_sharded(n, names(n), workload=spec, good_practice=True,
                             mesh=mesh, shard_chunk=SHARD_CHUNK, device=CPU)
    _per_device(sh, ref, world, "spec")
    _equal(sh.true_j, ref.true_j, "spec: true_j")
    assert np.array_equal(sh.scenarios, ref.scenarios), "spec: labels"
    assert sh.chunk_devices == world * SHARD_CHUNK
    for errs in ("naive_err", "gp_err"):
        _stats_close(sh.stats(getattr(sh, errs)),
                     ref.stats(getattr(ref, errs)), f"stats {errs}")
        g, w = (sh.by_scenario(getattr(sh, errs)),
                ref.by_scenario(getattr(ref, errs)))
        assert set(g) == set(w)
        for label in w:
            _stats_close(g[label], w[label], f"by_scenario {errs} {label}")
    assert sh.streamed["naive"]["overall"]["n_devices"] == n
    _streamed_close(sh.streamed, ref.streamed, "spec: streamed")

    via_mesh = fe.fleet_audit(n, names(n), workload=spec, good_practice=True,
                              chunk_devices=world * SHARD_CHUNK, mesh=mesh,
                              prefetch_workloads=True, device=CPU)
    quiet = fleet_audit_sharded(n, names(n), workload=spec,
                                good_practice=True, mesh=mesh,
                                shard_chunk=SHARD_CHUNK,
                                prefetch_workloads=False, device=CPU)
    for other, what in ((via_mesh, "mesh= against the entry point"),
                        (quiet, "prefetch off against on")):
        for key in ("naive_j", "gp_j", "naive_err", "gp_err", "true_j"):
            _equal(getattr(other, key), getattr(sh, key), f"{what}: {key}")
        assert np.array_equal(other.scenarios, sh.scenarios), what
        assert other.streamed == sh.streamed, what


def case_shared(world, rank, mesh):
    """One shared workload (no labels), 4 * 5 + 3 devices: in the last
    super-slab some ranks have no rows."""
    n = N_SHARED
    ref = fe.fleet_audit(n, names(n), seed=3, good_practice=True,
                         chunk_devices=5, device=CPU)
    sh = fleet_audit_sharded(n, names(n), seed=3, good_practice=True,
                             mesh=mesh, shard_chunk=5, device=CPU)
    assert sh.scenarios is None and sh.true_j == ref.true_j
    for key in ("naive_j", "gp_j"):
        _close(getattr(sh, key), getattr(ref, key), f"shared: {key}")
    _streamed_close(sh.streamed, ref.streamed, "shared: streamed")
    assert sh.streamed["good_practice"]["overall"]["n_devices"] == n


def case_workload_list(world, rank, mesh):
    """A list of per-device workloads (a WorkloadSet's rows per rank)."""
    n = N_SHARED
    wls = loads.mixed_fleet_workloads(n, seed=5, device=CPU)
    ref = fe.fleet_audit(n, names(n), workload=wls, seed=1,
                         chunk_devices=5, device=CPU)
    sh = fleet_audit_sharded(n, names(n), workload=wls, seed=1, mesh=mesh,
                             shard_chunk=5, device=CPU)
    _close(sh.naive_j, ref.naive_j, "list: naive_j")
    _equal(sh.true_j, ref.true_j, "list: true_j")
    assert np.array_equal(sh.scenarios, ref.scenarios), "list: labels"
    _streamed_close(sh.streamed, ref.streamed, "list: streamed")


def case_streaming_update(world, rank, mesh):
    """``StreamingMoments.update(e, mesh)`` over each rank's part of
    ``e`` equals the unsharded update of the whole."""
    e = torch.as_tensor(np.random.default_rng(3).normal(size=101))
    a, b = shard_rows(0, 101, world, rank)
    sm = fe.StreamingMoments().update(e[a:b], mesh)
    want = fe.StreamingMoments().update(e)
    assert sm.n == want.n
    np.testing.assert_allclose(
        [sm.mean, sm.m2, sm.mean_abs, sm.max_abs],
        [want.mean, want.m2, want.mean_abs, want.max_abs], rtol=1e-12)


CASES = (case_spec, case_shared, case_workload_list, case_streaming_update)


def run(rank, world, store):
    """One rank: join the gloo group, run every case, leave."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = data_mesh(world, "cpu")
        for case in CASES:
            case(world, rank, mesh)
    finally:
        dist.destroy_process_group()


def spawn(world, tmp_path, timeout_s):
    """Run :func:`run` in ``world`` spawned processes; returns their exit
    codes (``None`` for a rank still running at ``timeout_s``, which is
    then ended)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, str(tmp_path / "pg")))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    codes = []
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
        if p.is_alive():
            p.terminate()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes
