"""Wrapper of the CUDA ``stream_group`` kernels (``csrc/stream_group.cu``).

Groups a flat monitor slab by device: the preparation of
:meth:`repro_torch.core.stream.ingest.IngestCore.ingest` from the id and
finiteness checks through the sort by ``(device, t, arrival)``, the
duplicate and late flags and the drop counters to the compacted, baselined
samples and their group arrays, which ``stream_ingest`` and the fold take.
It replaces no TPU kernel: the reference sorts with ``np.lexsort``
(``src/repro/core/stream/ingest.py:298``).  On the card a counting sort by
device (an atomic histogram, one scan, one scatter) puts each sample in its
device's bucket, and one warp a bucket sorts it in registers, flags it and
compacts it; buckets above 1024 samples (the source's ``kWarpSortMax``)
take a merge route in the same source, counted under
``ingest.group_wide``.  Bound on an
H100: memory, about 177 bytes a sample.  The source's header says what the
design does about it.

:func:`stream_group_plain` is the plain version, the prep's code as it was:
CPU tensors take it, CUDA tensors the kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.common import spans
from repro_torch.kernels import _build, _launch

F64, I64, BOOL = torch.float64, torch.int64, torch.bool


class Grouped(NamedTuple):
    """A slab grouped by device.  The tensors are the kept samples sorted
    by ``(device, t, arrival)`` (``v`` less the device's baseline), each
    sample's group ``seg``, ``first`` of its group, and per group its
    bounds and device; the counts are those of the slab."""

    dev: torch.Tensor
    t: torch.Tensor
    v: torch.Tensor
    seg: torch.Tensor
    first: torch.Tensor
    start_idx: torch.Tensor
    end_idx: torch.Tensor
    u_dev: torch.Tensor
    rejected: int       # out-of-range ids (strict_ids=False)
    in_range: int       # samples with an id in range, finite or not
    invalid: int        # in range, non-finite t or v
    duplicates: int
    late: int


def _nothing(device, rejected, in_range=0, invalid=0, duplicates=0, late=0):
    """A :class:`Grouped` that keeps no sample."""
    e = torch.empty(0, dtype=I64, device=device)
    f = torch.empty(0, dtype=F64, device=device)
    return Grouped(e, f, f, e, torch.empty(0, dtype=BOOL, device=device),
                   e, e, e, rejected, in_range, invalid, duplicates, late)


def stream_group_plain(dev, t, v, has, last_t, n_dup, n_late, baseline_w,
                       strict_ids: bool = True) -> Grouped:
    """The plain version: ``dev`` [K] int64, ``t``/``v`` [K] f64 in any
    order; ``has``/``last_t`` [D] the devices' newest accepted sample,
    ``n_dup``/``n_late`` [D] int64 counters added to in place,
    ``baseline_w`` [D].  Out-of-range ids raise ``ValueError`` with
    ``strict_ids``, else they are rejected and counted."""
    d0 = dev.device
    n_rej = 0
    if dev.numel():
        ok_id = (dev >= 0) & (dev < has.shape[0])
        with spans.read("ingest.ids"):
            all_in = bool(ok_id.all())
        if not all_in:
            if strict_ids:
                raise ValueError("device id out of range")
            with spans.read("ingest.ids", 4):
                n_rej = int(ok_id.numel() - ok_id.sum())
                dev, t, v = dev[ok_id], t[ok_id], v[ok_id]
    k_in = dev.numel()
    if k_in == 0:
        return _nothing(d0, n_rej)

    ok = torch.isfinite(t) & torch.isfinite(v)
    with spans.read("ingest.finite"):
        n_invalid = int(k_in - ok.sum())
    if n_invalid:
        with spans.read("ingest.finite", 3):
            dev, t, v = dev[ok], t[ok], v[ok]

    # np.lexsort((t, dev)) as two stable sorts: by t, then by device
    order = torch.sort(t, stable=True).indices
    dev, t, v = dev[order], t[order], v[order]
    order = torch.sort(dev, stable=True).indices
    dev, t, v = dev[order], t[order], v[order]

    # duplicates: same (device, t) — keep the first arrival
    dup = torch.zeros_like(dev, dtype=torch.bool)
    dup[1:] = (dev[1:] == dev[:-1]) & (t[1:] == t[:-1])
    # vs stored state: strictly older samples arrive late, a repeat
    # of the newest timestamp is a duplicate
    has_d = has[dev]
    last_d = last_t[dev]
    late = ~dup & has_d & (t < last_d)
    dropped = dup | (~dup & has_d & (t == last_d))
    with spans.read("ingest.dups"):
        n_dup_s, n_late_s = (int(x) for x in torch.stack(
            [dropped.sum(), late.sum()]).tolist())
    if n_dup_s:
        with spans.read("ingest.dups"):
            n_dup.index_add_(0, dev[dropped], torch.ones(
                n_dup_s, dtype=I64, device=d0))
    if n_late_s:
        with spans.read("ingest.dups"):
            n_late.index_add_(0, dev[late], torch.ones(
                n_late_s, dtype=I64, device=d0))
    keep = ~(dropped | late)
    with spans.read("ingest.keep", 3):
        dev, t, v = dev[keep], t[keep], v[keep]
    k = dev.numel()
    if k == 0:
        return _nothing(d0, n_rej, k_in, n_invalid, n_dup_s, n_late_s)

    v = v - baseline_w[dev]

    # compact to per-slab groups (devices sorted => contiguous)
    first = torch.ones_like(dev, dtype=torch.bool)
    first[1:] = dev[1:] != dev[:-1]
    with spans.read("ingest.groups"):
        start_idx = torch.nonzero(first)[:, 0]
    end_idx = torch.cat([start_idx[1:] - 1,
                         torch.full((1,), k - 1, dtype=I64, device=d0)])
    u_dev = dev[start_idx]
    seg = torch.cumsum(first, 0) - 1
    return Grouped(dev, t, v, seg, first, start_idx, end_idx, u_dev, n_rej,
                   k_in, n_invalid, n_dup_s, n_late_s)


def _lib_size(fn: str, restype, *args) -> int:
    f = getattr(_build.load("stream_group"), fn)
    f.restype = restype
    f.argtypes = [type(a) for a in args]
    return int(f(*args))


def stream_group(dev, t, v, has, last_t, n_dup, n_late, baseline_w,
                 strict_ids: bool = True) -> Grouped:
    """:func:`stream_group_plain` on CPU tensors; the CUDA kernels on CUDA
    tensors, with the same outputs bit for bit.  ``stream_group.launches``
    counts the calls into the kernels' library: three for a slab that keeps
    a sample (count, sort, emit), fewer where nothing is left to sort or
    to emit, none for an empty slab."""
    if dev.device.type == "cpu":
        return stream_group_plain(dev, t, v, has, last_t, n_dup, n_late,
                                  baseline_w, strict_ids)
    if dev.device.type != "cuda":
        raise ValueError(f"stream_group runs on cpu or cuda tensors, "
                         f"got {dev.device}")
    k, n = dev.shape[0], has.shape[0]
    if k >= 2**31:
        raise ValueError(f"stream_group takes at most 2**31 - 1 samples a "
                         f"slab on the card, got {k}")
    ins = _launch.check("stream_group", dev.device, [
        ("dev", dev, I64, (k,)), ("t", t, F64, (k,)), ("v", v, F64, (k,)),
        ("has", has, BOOL, (n,)), ("last_t", last_t, F64, (n,)),
        ("n_dup", n_dup, I64, (n,)), ("n_late", n_late, I64, (n,)),
        ("baseline_w", baseline_w, F64, (n,))])
    for name, x in (("n_dup", n_dup), ("n_late", n_late)):
        if not x.is_contiguous():
            raise ValueError(f"stream_group: {name} is added to in place "
                             f"and must be contiguous")
    if k == 0:
        return _nothing(dev.device, 0)
    ws = torch.empty(_lib_size("stream_group_workspace_bytes",
                               ctypes.c_int64, ctypes.c_int64(n)),
                     dtype=torch.uint8, device=dev.device)
    ptrs = ins + [ws] + [None] * 9
    n_k, n_d = ctypes.c_int64(k), ctypes.c_int64(n)
    _launch.launch("stream_group", dev.device, ptrs, n_k, n_d,
                   entry="stream_group_count_launch")
    stream_group.launches += 1
    stats = ws[:128].view(I64)
    with spans.read("ingest.group"):
        n_rej, n_invalid, n_valid, n_wide, max_bucket = stats[:5].tolist()
    if n_rej and strict_ids:
        raise ValueError("device id out of range")
    in_range = n_valid + n_invalid
    if n_valid == 0:
        return _nothing(dev.device, n_rej, in_range, n_invalid)

    spans.count("ingest.group_wide", n_wide)
    ptrs[9] = torch.empty(
        _lib_size("stream_group_scratch_bytes", ctypes.c_int64,
                  ctypes.c_int64(n_valid), ctypes.c_int(int(n_wide > 0))),
        dtype=torch.uint8, device=dev.device)
    _launch.launch("stream_group", dev.device, ptrs, n_k, n_d,
                   ctypes.c_int64(n_valid), ctypes.c_int64(n_wide),
                   ctypes.c_int64(max_bucket),
                   entry="stream_group_sort_launch")
    stream_group.launches += 1
    with spans.read("ingest.group"):
        n_dup_s, n_late_s, kept, n_groups = stats[5:9].tolist()
    if kept == 0:
        return _nothing(dev.device, n_rej, in_range, n_invalid, n_dup_s,
                        n_late_s)

    def empty(m, dtype):
        return torch.empty(m, dtype=dtype, device=dev.device)

    outs = [empty(kept, I64), empty(kept, F64), empty(kept, F64),
            empty(kept, I64), empty(kept, BOOL), empty(n_groups, I64),
            empty(n_groups, I64), empty(n_groups, I64)]
    ptrs[10:] = outs
    _launch.launch("stream_group", dev.device, ptrs, n_d,
                   ctypes.c_int64(n_valid), entry="stream_group_emit_launch")
    stream_group.launches += 1
    return Grouped(*outs, n_rej, in_range, n_invalid, n_dup_s, n_late_s)


stream_group.launches = 0
