"""Architecture registry of the port: ``get_config(arch_id)`` for every
architecture the reference registers, in its order."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig

_MODULES: Dict[str, str] = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; available: {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    cfg = mod.REDUCED if reduced else mod.CONFIG
    cfg.validate()
    return cfg
