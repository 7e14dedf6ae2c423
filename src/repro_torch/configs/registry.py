"""Architecture registry of the port: ``get_config(arch_id)``.

The port registers the architectures whose blocks it runs, in the
reference's order; the JAX package's other architectures raise
``KeyError`` naming ROADMAP A.6, where their port is queued.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig

_MODULES: Dict[str, str] = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)

def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"arch '{arch_id}' is not in the port (ROADMAP A.6 "
                       f"lists what is still to port); the port has: "
                       f"{ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch_id])
    cfg = mod.REDUCED if reduced else mod.CONFIG
    cfg.validate()
    return cfg
