"""Wrapper of the CUDA ``log_filter`` kernel (``csrc/log_filter.cu``).

Replaces the TPU kernel ``_scan_kernel``
(``src/repro/core/engine_backend/pallas_backend.py:497,516,566``): the
Kepler/Maxwell first-order sensor filter.  Each row's state walks its
segments in order, then each tick decays the state at the start of its
segment.  Bound on an H100: memory, 16 bytes per tick (tick in, reading
out).  The source's header says what the design does about it.

Two routes, chosen by :func:`plan` from the shape alone; a failed build
or launch raises, it never takes the other route:

* :data:`SHARED_MEMORY`: one launch, a block a tile of ``rows`` tick
  rows, the entry states in shared memory;
* :data:`TWO_LAUNCH`: where one row's states do not fit in shared memory
  (S above ~8,000 segments), a states pass into a [S + 1, G] scratch,
  then a readings pass.

Neither takes the plain version's padding span: a tick's reading does
not depend on it (the source's header says why).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.engine_backend import torch_backend as _tb
from repro_torch.engine_backend.pytrees import TimelineArrays
from repro_torch.kernels import _launch

F64 = torch.float64
SHARED_MEMORY = "shared_memory"
TWO_LAUNCH = "two_launch"
ROUTES = (SHARED_MEMORY, TWO_LAUNCH)
#: the source's kThreads, kStages * kChunk and kMaxSmem
THREADS = 256
RING_TICKS = 4 * 4 * THREADS
MAX_SMEM_BYTES = 232448
#: an H100 SXM's SMs: a tile of ``rows`` is halved from 32 down to 8
#: while the grid has fewer blocks than SMs
SMS = 132
#: the most ticks a tile may hold (its indices are 32-bit)
MAX_TILE_TICKS = 1 << 30


def tile_smem_bytes(r: int, s: int, rows: int) -> int:
    """Shared memory of a tile of ``rows`` rows (``TileLayout::bytes``):
    the ring of ticks, tau, 1 / tau and idle (4 doubles a row), the edges
    padded to a power of two above S + 1 and the powers (one shared row,
    or a row each), the entry states at an odd stride."""
    nt = 1 if r == 1 else rows
    es = 1 << (s + 1).bit_length()
    return 8 * (RING_TICKS + 4 * rows + nt * (es + s + 1)
                + rows * ((s + 1) | 1))


def plan(r: int, g: int, s: int, m: int) -> tuple:
    """``(route, rows)`` for [g, m] ticks against ``r`` timeline rows of
    ``s`` segments: the largest of 32, 16 and 8 rows a tile that still
    gives every SM a block (8 at least; 16 at the audit's G = 4183, two
    blocks an SM), halved down to 1 until the tile fits in shared memory
    and holds at most ``MAX_TILE_TICKS``; :data:`TWO_LAUNCH` (rows 0)
    where one row does not."""
    rows = 32
    while rows > 8 and -(-g // rows) < SMS:
        rows //= 2

    def fits(rows):
        return (tile_smem_bytes(r, s, rows) <= MAX_SMEM_BYTES
                and rows * m <= MAX_TILE_TICKS)
    while rows > 1 and not fits(rows):
        rows //= 2
    if not fits(rows):
        return TWO_LAUNCH, 0
    return SHARED_MEMORY, rows


def log_filter(tl: TimelineArrays, ticks: torch.Tensor,
               tau: torch.Tensor) -> torch.Tensor:
    """:func:`repro_torch.engine_backend.torch_backend.log_filter` on CPU
    tensors; the CUDA kernel on CUDA tensors."""
    if ticks.device.type == "cpu":
        return _tb.log_filter(tl, ticks, tau)
    if ticks.device.type != "cuda":
        raise ValueError(f"log_filter runs on cpu or cuda tensors, got "
                         f"{ticks.device}")
    g, m = ticks.shape
    r, s1 = tl.edges.shape
    s = s1 - 1
    if r not in (1, g):
        raise ValueError(f"log_filter: {g} tick rows for {r} timeline rows")
    ins = _launch.check("log_filter", ticks.device, [
        ("edges", tl.edges, F64, (r, s + 1)),
        ("powers", tl.powers, F64, (r, s)),
        ("idle_w", tl.idle_w, F64, (r,)), ("ticks", ticks, F64, (g, m)),
        ("tau", tau, F64, (g,))])
    out = torch.empty((g, m), dtype=F64, device=ticks.device)
    if g == 0 or m == 0:
        return out
    route, rows = plan(r, g, s, m)
    states = (None if route == SHARED_MEMORY else
              torch.empty((s + 1, g), dtype=F64, device=ticks.device))
    _launch.launch("log_filter", ticks.device, ins + [states, out],
                   ctypes.c_int64(r), ctypes.c_int64(g), ctypes.c_int64(s),
                   ctypes.c_int64(m), ctypes.c_int(rows))
    log_filter.launches += 1
    log_filter.launches_by_route[route] += 1
    return out


def reset_launches() -> None:
    """Set the total and every route's count to 0."""
    log_filter.launches = 0
    log_filter.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()
