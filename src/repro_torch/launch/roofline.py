"""Three-term roofline of a traced dry-run step on the NVIDIA H100 (a port
of :mod:`repro.launch.roofline`, whose constants are a TPU's).

    compute term    = Σ over operand types of dot FLOPs a rank / that
                      type's peak FLOP/s
    memory term     = modelled HBM bytes a rank / HBM bandwidth
    collective term = collective bytes a rank / collective bandwidth

Constants, one H100 SXM:
  * 989e12 FLOP/s: dense bf16 (and f16) on the tensor cores (NVIDIA's
    H100 data sheet, SXM, without sparsity), the peak ``PERF.md`` states
    kernel bounds against;
  * 67e12 FLOP/s: f32 on the CUDA cores (the same sheet), for a product
    of f32 operands (the port's unembedding; TF32 stays off, PyTorch's
    default), as ``PERF.md`` states f32 bounds;
  * 3.35e12 B/s of HBM3 bandwidth and 80e9 B of HBM (the same sheet);
  * 50e9 B/s of collective bandwidth a GPU: one 400 Gb/s NDR InfiniBand
    port a GPU in NVIDIA's DGX H100 reference architecture (its
    SuperPOD's compute fabric), since both 16-wide mesh axes cross nodes
    of 8 GPUs.  Inside a node NVLink 4 gives 450 GB/s a direction a GPU;
    a collective over an axis that stayed inside a node would see that.

The counts come from the traced step (:mod:`repro_torch.launch.opcount`):
  * FLOPs: the dot FLOPs of one rank's local ops, by
    ``torch.utils.flop_counter``'s formulas (the MFU convention counts
    products only), each at the rate of its operands' type;
  * HBM bytes: the raw bytes every local op reads and writes, each op on
    its own (eager, nothing fused), are kept as ``memory_raw_s``; the
    memory term uses the reference's analytic traffic model
    (:func:`analytic_traffic`: weights, optimizer shard, activation
    checkpoints, KV cache, logits), as the reference's does;
  * collective bytes: each collective's result, summed over the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell

PEAK_FLOPS = 989e12         # bf16 dense, one H100 SXM
F32_FLOPS = 67e12           # f32 on the CUDA cores, one H100 SXM
#: the peak rate of a product by its operands' type
FLOPS_BY_DTYPE = {torch.bfloat16: PEAK_FLOPS, torch.float16: PEAK_FLOPS,
                  torch.float32: F32_FLOPS}
HBM_BW = 3.35e12            # bytes/s, one H100 SXM
COLL_BW = 50e9              # bytes/s a GPU: one 400 Gb/s NDR port
HBM_PER_CHIP = 80e9         # bytes of HBM, one H100


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw per-device counts
    cost_flops_per_device: float
    cost_bytes_per_device: float
    dot_flops_per_device: float
    coll_bytes_per_device: float
    analytic_bytes_per_device: float
    peak_memory_per_device: float
    # terms (seconds)
    compute_s: float
    memory_s: float
    memory_raw_s: float
    collective_s: float
    bottleneck: str
    # usefulness
    model_flops: float
    hlo_global_flops: float
    useful_ratio: float          # MODEL_FLOPS / traced FLOPs
    roofline_fraction: float     # useful-compute time / bottleneck time
    fits_hbm: bool
    note: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def model_flops_for(cfg: ArchConfig, shape: ShapeCell,
                    active_params: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference); N_active for
    MoE."""
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active_params * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active_params * tokens
    return 2.0 * active_params * shape.global_batch   # decode: 1 tok/seq


def analytic_traffic(cfg: ArchConfig, shape: ShapeCell, chips: int,
                     total_params: int, active_params: int) -> float:
    """Modelled HBM bytes a device a step, the reference's model:

    train:   the gathered weights read forward and backward (2 · 2 B ·
             N_active) + the optimizer shard (f32 m, v, grad and the
             parameter read and written, 20 · N_total / chips) + the
             activation checkpoints (L × local tokens × d × 2 B, saved and
             restored) + the logits (local tokens × V/tp × 4 B × 2).
    prefill: the gathered weights once + the activations + the KV writes.
    decode:  each chip's weight shard + its KV/state cache + the logits.
    """
    B, S = shape.global_batch, shape.seq_len
    V, D, L = cfg.vocab, cfg.d_model, cfg.n_layers
    # the mesh split the sharding rules' default layout gives
    tp = 16 if chips >= 256 else max(1, int(np.sqrt(chips)))
    dp = chips // tp
    tokens_local = max(1, (B * S) // dp) if shape.mode != "decode" else \
        max(1, B // dp)

    if shape.mode == "train":
        w = 2 * active_params * 2.0
        opt = 20.0 * total_params / chips
        act = L * tokens_local * D * 2.0 * 2.0
        logits = tokens_local * (V // tp) * 4.0 * 2.0
        return w + opt + act + logits
    if shape.mode == "prefill":
        w = active_params * 2.0
        act = L * tokens_local * D * 2.0
        kv = L * tokens_local * cfg.n_kv_heads * cfg.head_dim * 2 * 2.0
        return w + act + kv
    w = total_params * 2.0 / chips
    kv_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    kv = (L * tokens_local * kv_len * cfg.n_kv_heads * cfg.head_dim
          * 2 * 2.0 / tp)
    logits = tokens_local * (V // tp) * 4.0
    return w + kv + logits


def analyze(counter, cfg: ArchConfig, shape: ShapeCell, mesh_name: str,
            chips: int, model_flops: float, total_params: int,
            active_params: int) -> RooflineReport:
    """The report of one traced step: ``counter`` is the
    :class:`~repro_torch.launch.opcount.TraceCounter` that counted it."""
    dot_dev = float(counter.dot_flops)
    coll_dev = counter.collectives.total_bytes
    peak = float(counter.peak_bytes)
    analytic_dev = analytic_traffic(cfg, shape, chips,
                                    total_params or active_params,
                                    active_params)
    hlo_global = dot_dev * chips
    compute_s = sum(n / FLOPS_BY_DTYPE[dt]
                    for dt, n in counter.dot_flops_by_dtype.items())
    memory_s = analytic_dev / HBM_BW
    memory_raw_s = counter.bytes_accessed / HBM_BW
    collective_s = coll_dev / COLL_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values()) or 1e-12
    useful = model_flops / hlo_global if hlo_global > 0 else 0.0
    useful_compute_s = model_flops / (chips * PEAK_FLOPS)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        cost_flops_per_device=dot_dev,
        cost_bytes_per_device=float(counter.bytes_accessed),
        dot_flops_per_device=dot_dev,
        coll_bytes_per_device=coll_dev,
        analytic_bytes_per_device=analytic_dev,
        peak_memory_per_device=peak,
        compute_s=compute_s, memory_s=memory_s, memory_raw_s=memory_raw_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops, hlo_global_flops=hlo_global,
        useful_ratio=useful,
        roofline_fraction=useful_compute_s / step_time,
        fits_hbm=peak <= HBM_PER_CHIP,
    )


def format_report(r: RooflineReport) -> str:
    return (f"{r.arch:22s} {r.shape:12s} {r.mesh:10s} "
            f"comp={r.compute_s*1e3:9.3f}ms mem={r.memory_s*1e3:9.3f}ms "
            f"coll={r.collective_s*1e3:9.3f}ms -> {r.bottleneck:10s} "
            f"useful={r.useful_ratio:6.3f} frac={r.roofline_fraction:6.3f} "
            f"peakmem={r.peak_memory_per_device/1e9:7.2f}GB "
            f"{'FITS' if r.fits_hbm else 'OVER'}")
