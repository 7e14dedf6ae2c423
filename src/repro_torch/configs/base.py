"""ArchConfig — the model-config schema (a copy of
:mod:`repro.configs.base`'s, every field kept so that a reference config's
``to_dict`` round-trips) — and the assigned input-shape cells,
:class:`ShapeCell`, :data:`SHAPES`, :func:`get_shape` and
:func:`cell_applicable`."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.common.config import Config


@dataclasses.dataclass(frozen=True)
class ArchConfig(Config):
    name: str = ""
    family: str = "dense"        # dense | moe | ssm | vlm | audio | hybrid

    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab: int = 1000

    # a repeating pattern of block kinds; "attn" blocks include the MLP,
    # recurrent kinds are self-contained
    block_pattern: Tuple[str, ...] = ("attn",)

    # attention
    sliding_window: int = 0          # 0 = full attention
    alt_local_global: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10_000.0
    mrope: bool = False

    # MoE (the expert dimension is padded to a multiple of expert_pad_to)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    expert_pad_to: int = 16

    # norms / embeddings
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    tie_embeddings: bool = True
    act: str = "silu"

    # encoder-decoder
    encdec: bool = False
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # "tokens" (LM) or "embeds" (VLM/audio)
    input_mode: str = "tokens"

    # recurrent dims
    d_rec: int = 0                   # RG-LRU width (0 => d_model)
    conv_width: int = 4
    mlstm_chunk: int = 128

    param_dtype: str = "bfloat16"

    @property
    def d_rec_actual(self) -> int:
        return self.d_rec or self.d_model

    @property
    def n_experts_padded(self) -> int:
        """Experts padded to a multiple of ``expert_pad_to``; the padding
        experts receive no tokens."""
        if self.n_experts == 0:
            return 0
        p = self.expert_pad_to
        return ((self.n_experts + p - 1) // p) * p

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token decode cell?  True when no
        block needs unbounded full attention."""
        kinds = set(self.block_pattern)
        if "attn" in kinds and self.sliding_window == 0:
            return False
        if "attn_global" in kinds:   # gemma2's global layers
            return False
        if self.encdec:              # full cross and self attention
            return False
        return True

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer block kinds, length n_layers."""
        per = len(self.block_pattern)
        return tuple(self.block_pattern[i % per]
                     for i in range(self.n_layers))

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0, (self.n_heads,
                                                     self.n_kv_heads)
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0
        if self.encdec:
            assert self.n_enc_layers > 0 and self.n_dec_layers > 0


@dataclasses.dataclass(frozen=True)
class ShapeCell(Config):
    """One assigned input-shape cell."""
    name: str = ""
    seq_len: int = 0
    global_batch: int = 0
    mode: str = "train"      # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Whether an (arch × shape) cell runs; the reason where it does not."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k decode is quadratic "
                       "(skip per brief)")
    return True, ""
