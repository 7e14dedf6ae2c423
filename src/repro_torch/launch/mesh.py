"""Meshes on :mod:`torch.distributed`: the ``("data",)`` mesh of the
sharded fleet audit, and the production meshes of the dry run.

The counterpart of :mod:`repro.launch.mesh`'s
``make_production_mesh``, ``make_mesh``, ``data_mesh``, ``n_chips`` and
``require_devices``.  A shard is a process: the caller starts one per shard and joins them in a process
group (``torch.distributed.init_process_group`` with its address, world
size and rank) before building a mesh.  Ranks on different cards use
NCCL; the CPU, and ranks that share a card (NCCL refuses two on one
GPU), use gloo.  The mesh spans the whole group: unlike the reference,
which may take the first ``n`` of the visible devices, a mesh of fewer
shards than the world is refused.

The dry run builds its production meshes over placeholder ranks:
:func:`fake_process_group` starts a process group of the ``"fake"``
backend in this one process (every collective returns at once and moves
nothing), as the reference forces 512 placeholder host devices.

Nothing here touches the process group when it is imported.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist


def require_devices(n: int) -> None:
    """Raise unless a process group of at least ``n`` ranks is up, naming
    what is missing."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a mesh of {n} shards needs an initialised process group: "
            "start one process per shard and call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) in each")
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(f"a mesh of {n} shards needs {n} ranks, but the "
                           f"process group has {have}")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` of ``shape``
    named ``axes`` over the whole process group, on ``device_type``
    (``"cuda"`` unless the caller asks for ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    n = 1
    for s in shape:
        n *= s
    require_devices(n)
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {n} shards over a process group of "
                         f"{dist.get_world_size()} ranks: the port's mesh "
                         "spans the whole group")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the mesh is on the card "
                           "by default; pass device_type=\"cpu\" for a mesh "
                           "of CPU processes")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``, over the process group the
    caller set up (256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A process group of ``world_size`` placeholder ranks in this process
    (the ``"fake"`` backend, this process rank 0), destroyed on exit.
    Collectives on it return at once and move nothing: it gives a
    :class:`~torch.distributed.device_mesh.DeviceMesh` its shape for a
    trace under ``FakeTensorMode``, never a result."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run's placeholder ranks need the \"fake\" process "
            "group backend, whose store torch ships in "
            "torch.testing._internal.distributed.fake_pg; this torch "
            f"build has none ({e})") from e
    if dist.is_initialized():
        raise RuntimeError("fake_process_group: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def data_mesh(n_shards: Optional[int] = None,
              device_type: Optional[str] = None):
    """The 1-D ``("data",)`` mesh of the sharded fleet audit over the
    process group's ``n_shards`` ranks (default: the world size).
    ``device_type`` is ``"cuda"`` unless the caller passes ``"cpu"``; a
    rank on the card sets its current device first
    (``torch.cuda.set_device``)."""
    if n_shards is None:
        require_devices(1)
        n_shards = dist.get_world_size()
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    return make_mesh((n,), ("data",), device_type or "cuda")


def n_chips(mesh) -> int:
    """The number of shards (processes) of ``mesh``."""
    return int(mesh.size())
