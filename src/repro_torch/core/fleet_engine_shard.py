"""The fleet audit sharded over a ``("data",)`` mesh of processes.

The counterpart of :mod:`repro.core.fleet_engine_shard`.  The reference
``shard_map``s each kernel of the audit over the devices of one jax
process; here a shard is a process of a :mod:`torch.distributed` group
(:func:`repro_torch.launch.mesh.data_mesh`), so that each shard has a
host thread of its own to dispatch from (the port's audit is bound by
its host).  Every rank calls :func:`fleet_audit_sharded` (or
``fleet_audit(mesh=...)``) with the same arguments:

* the fleet streams in super-slabs of ``n_shards x shard_chunk`` rows;
  rank ``r`` audits the ``r``-th part of each (:func:`shard_rows`: parts
  of ``ceil(rows / k)`` rows, as the reference's padding splits them, so
  in the last, short super-slab some ranks may have none), running on
  its rows the unsharded loop's own code
  (:func:`~repro_torch.core.fleet_engine._audit_slab`);
* per super-slab, each rank reduces its errors to Chan moment blocks
  (:func:`local_moments`: overall and one per scenario label), the
  blocks are gathered (``all_gather_into_tensor``) and merged on the
  rank's device by a log-depth tree (:func:`tree_merge_moments`), and
  the merged blocks fold into host-side
  :class:`~repro_torch.core.fleet_engine.StreamingMoments`, one block a
  super-slab, as the reference's ``ShardedBackend.err_moments`` feeds
  them;
* the per-device results are gathered too (each rank's part padded to
  ``ceil(rows / k)`` for the collective and sliced back) with the labels
  (``all_gather_object``), so every rank returns the whole
  :class:`~repro_torch.core.fleet_engine.FleetAuditResult`.

A rank with no rows in a super-slab still joins every collective, with
zero blocks: the empty block is the identity of the Chan merge.  Every
rank makes the same collectives in the same order, from its main thread
(the workload prefetch thread only synthesises).  Hidden parameters are
drawn once for the fleet and the reading noise, §5 offsets and scenario
draws are addressed by fleet row, so a rank computes for its rows what
the unsharded audit computes for them: bitwise where its rows are an
unsharded slab, else to the order of float sums (``attach`` pads a
bank to its widest row).

Gloo moves host tensors: with a gloo group (the CPU, or ranks that share
a card) the gathered tensors go through the host.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import fleet_engine as fe

__all__ = ["fleet_audit_sharded", "local_moments", "mesh_moments",
           "shard_rows", "tree_merge_moments"]

F64 = torch.float64


# ---------------------------------------------------------------------------
# The Chan tree
# ---------------------------------------------------------------------------

def _chan_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge moment blocks pairwise: ``a``/``b`` are ``[..., 5]`` stacks
    of ``(count, mean, M2, mean_abs, max_abs)``; returns their Chan
    parallel-Welford combination, the reference's formulas.  An empty
    block (count 0) is the identity on either side."""
    na, nb = a[..., 0], b[..., 0]
    tot = na + nb
    safe = torch.clamp(tot, min=1.0)
    delta = b[..., 1] - a[..., 1]
    mean = a[..., 1] + delta * nb / safe
    m2 = a[..., 2] + b[..., 2] + delta * delta * na * nb / safe
    mean_abs = a[..., 3] + (b[..., 3] - a[..., 3]) * nb / safe
    max_abs = torch.maximum(a[..., 4], b[..., 4])
    merged = torch.stack([tot, mean, m2, mean_abs, max_abs], dim=-1)
    merged = torch.where((nb == 0)[..., None], a, merged)
    return torch.where((na == 0)[..., None], b, merged)


def tree_merge_moments(blocks: torch.Tensor) -> torch.Tensor:
    """Fold ``[k, ..., 5]`` f64 moment blocks to one ``[..., 5]`` block
    on their device through a log-depth binary tree (``blocks[0::2]`` ⊕
    ``blocks[1::2]`` a level), with no host read.  ``k`` is padded to a
    power of two with zero blocks, which the merge leaves exact."""
    blocks = torch.as_tensor(blocks, dtype=F64)
    k = blocks.shape[0]
    if k < 1:
        raise ValueError("no moment blocks to merge")
    p = 1 << (k - 1).bit_length()
    if p > k:
        blocks = torch.cat([blocks, blocks.new_zeros(
            (p - k,) + tuple(blocks.shape[1:]))])
    while blocks.shape[0] > 1:
        blocks = _chan_pair(blocks[0::2], blocks[1::2])
    return blocks[0]


def local_moments(e: torch.Tensor) -> torch.Tensor:
    """This rank's ``(count, mean, M2, mean_abs, max_abs)`` of errors
    ``e`` as a ``[5]`` f64 tensor on ``e``'s device: the same ops as
    ``torch_backend.err_moments`` (so the values are its, bitwise), zeros
    for no errors."""
    e = e.reshape(-1).to(F64)
    n = e.numel()
    if n == 0:
        return torch.zeros(5, dtype=F64, device=e.device)
    mean = e.mean()
    ae = e.abs()
    return torch.stack([torch.full((), float(n), dtype=F64, device=e.device),
                        mean, ((e - mean) ** 2).sum(), ae.mean(), ae.max()])


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

def _data_group(mesh):
    """The process group of ``mesh``'s ``"data"`` dimension."""
    if "data" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError(
            f"mesh {mesh!r} has no \"data\" dimension; build one with "
            "repro_torch.launch.mesh.data_mesh(n_shards)")
    return mesh.get_group("data")


def _rank_device(mesh, device: DeviceLike) -> torch.device:
    """The rank's device: ``device`` as given, a CUDA device without an
    index taking card ``rank % device_count()``; it must be of the mesh's
    device type."""
    want = torch.device(device)
    if want.type != mesh.device_type:
        raise ValueError(f"device {want} is not of the mesh's device type "
                         f"{mesh.device_type!r}")
    dev = resolve_device(want)
    if dev.type == "cuda" and want.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """``[k, *t.shape]``: every rank's ``t`` in rank order, on ``t``'s
    device.  A gloo group gathers host tensors, so a card's tensor goes
    through the host for it."""
    k = dist.get_world_size(group)
    src = t.reshape(-1).contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()
    out = src.new_empty(k * src.numel())
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view((k,) + tuple(t.shape)).to(t.device)


def mesh_moments(e: torch.Tensor, mesh) -> Tuple[int, float, float, float,
                                                 float]:
    """The moments of every rank's errors: this rank's
    :func:`local_moments` of ``e``, gathered over ``mesh``'s ``"data"``
    dimension and merged by :func:`tree_merge_moments`; one host read."""
    merged = tree_merge_moments(_gather(local_moments(e), _data_group(mesh)))
    n, mean, m2, mean_abs, max_abs = merged.tolist()
    return int(n), mean, m2, mean_abs, max_abs


def shard_rows(lo: int, hi: int, k: int, r: int) -> Tuple[int, int]:
    """Rank ``r``'s rows of super-slab ``[lo, hi)`` over ``k`` ranks: the
    ``r``-th part of ``ceil((hi - lo) / k)`` rows, short or empty at the
    end."""
    per = -(-(hi - lo) // k)
    a = min(lo + r * per, hi)
    return a, min(a + per, hi)


# ---------------------------------------------------------------------------
# The sharded audit
# ---------------------------------------------------------------------------

def audit_over_mesh(n_devices: int, profile, workload, seed: int,
                    good_practice: bool, n_trials: int, *, chunk: int, mesh,
                    prefetch_workloads: bool,
                    device: DeviceLike) -> fe.FleetAuditResult:
    """``fleet_audit(..., chunk_devices=chunk, mesh=mesh)``: the audit in
    super-slabs of ``chunk`` rows, each split over the mesh's ranks."""
    group = _data_group(mesh)
    k, r = dist.get_world_size(group), dist.get_rank(group)
    dev = _rank_device(mesh, device)
    if chunk < 1:
        raise ValueError(f"chunk_devices must be >= 1, got {chunk}")
    workload, names, spec, ws_full, calibs = fe._audit_setup(
        n_devices, profile, workload, good_practice, dev)
    shared = spec is None and ws_full is None
    supers = [(lo, min(lo + chunk, n_devices))
              for lo in range(0, n_devices, chunk)]
    mine = [shard_rows(lo, hi, k, r) for lo, hi in supers]
    keys = ["naive_j", "naive_err"] + ([] if shared else ["true_j"]) + (
        ["gp_j", "gp_err"] if good_practice else [])
    errs = ["naive"] + (["good_practice"] if good_practice else [])
    sm = {key: {"overall": fe.StreamingMoments(), "by_scenario": {}}
          for key in errs}
    scenarios = None if shared else np.empty(n_devices, dtype=object)

    # NCCL's object collectives stage on the current card
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        fleet = fe._fleet_bank(names, seed, dev)
        full = {key: torch.empty(n_devices, dtype=F64, device=dev)
                for key in keys}
        ws_iter = fe._slab_workloads(spec, ws_full,
                                     [(a, b) for a, b in mine if b > a],
                                     prefetch_workloads, dev)
        for (lo, hi), (a, b) in zip(supers, mine):
            per = -(-(hi - lo) // k)
            part = torch.zeros((len(keys), per), dtype=F64, device=dev)
            out = {key: part[i, :0] for i, key in enumerate(keys)}
            labels = np.empty(0, dtype=object)
            if b > a:
                out, lab = fe._audit_slab(fleet, a, b, next(ws_iter),
                                          workload, calibs, good_practice,
                                          n_trials)
                for i, key in enumerate(keys):
                    part[i, :b - a] = out[key]
                if lab is not None:
                    labels = lab

            got = _gather(part, group)
            sizes = [q1 - q0 for q0, q1 in
                     (shard_rows(lo, hi, k, q) for q in range(k))]
            slab = torch.cat([got[q, :, :sizes[q]] for q in range(k)], dim=1)
            for i, key in enumerate(keys):
                full[key][lo:hi] = slab[i]
            vocab: Sequence[str] = ()
            if not shared:
                parts: List[Optional[np.ndarray]] = [None] * k
                dist.all_gather_object(parts, labels, group=group)
                scenarios[lo:hi] = np.concatenate(parts)
                vocab = [str(x) for x in np.unique(scenarios[lo:hi])]

            blocks = []
            for key in errs:
                e = out["naive_err" if key == "naive" else "gp_err"]
                blocks.append(local_moments(e))
                blocks.extend(local_moments(
                    e[torch.as_tensor(labels == label, device=dev)])
                    for label in vocab)
            merged = tree_merge_moments(_gather(torch.stack(blocks), group))
            rows = iter(merged.tolist())
            for key in errs:
                n, *rest = next(rows)
                sm[key]["overall"].merge(int(n), *rest)
                for label in vocab:
                    n, *rest = next(rows)
                    sm[key]["by_scenario"].setdefault(
                        label, fe.StreamingMoments()).merge(int(n), *rest)

    return fe.FleetAuditResult(
        n_devices=n_devices, profile_names=names,
        true_j=(workload.true_energy_j if shared else full["true_j"]),
        naive_j=full["naive_j"], naive_err=full["naive_err"],
        gp_j=full.get("gp_j"), gp_err=full.get("gp_err"),
        scenarios=scenarios, chunk_devices=chunk,
        streamed=fe._streamed(sm))


def fleet_audit_sharded(n_devices: int,
                        profile: Union[str, Sequence[str]] = "a100",
                        workload=None, seed: int = 0,
                        good_practice: bool = False, n_trials: int = 2,
                        n_shards: Optional[int] = None, mesh=None,
                        shard_chunk: Optional[int] = None,
                        prefetch_workloads: bool = True,
                        device: DeviceLike = "cuda") -> fe.FleetAuditResult:
    """A :func:`~repro_torch.core.fleet_engine.fleet_audit` sharded over
    the ranks of a ``"data"`` mesh; every rank calls it with the same
    arguments and gets the whole result.

    Super-slabs of ``n_shards x shard_chunk`` rows stream through the
    audit, so each rank audits ``shard_chunk`` rows a step (default
    ``min(ceil(n / k), 25_000)``, the reference's); the next super-slab's
    workloads are synthesised on a worker thread meanwhile
    (``prefetch_workloads``, on by default as in the reference).
    ``mesh`` defaults to :func:`~repro_torch.launch.mesh.data_mesh` of
    ``n_shards`` ranks (the world) on ``device``'s type.  ``device`` is
    the rank's device: ``"cuda"`` (card ``rank % device_count()``)
    unless the caller passes ``"cpu"``.
    """
    if mesh is None:
        from repro_torch.launch.mesh import data_mesh
        mesh = data_mesh(n_shards, torch.device(device).type)
    k = dist.get_world_size(_data_group(mesh))
    if n_shards is not None and int(n_shards) != k:
        raise ValueError(f"n_shards={n_shards} but the mesh has {k} shards")
    if shard_chunk is None:
        shard_chunk = min(max(math.ceil(n_devices / k), 1), 25_000)
    chunk = min(int(shard_chunk) * k, max(n_devices, 1))
    return audit_over_mesh(n_devices, profile, workload, seed, good_practice,
                           n_trials, chunk=chunk, mesh=mesh,
                           prefetch_workloads=prefetch_workloads,
                           device=device)
