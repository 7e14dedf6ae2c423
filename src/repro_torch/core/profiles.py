"""Sensor-profile catalog — Fig. 14 of the paper as data (a copy of
:mod:`repro.core.profiles`).

Each entry is one row of the paper's all-GPU summary plus the GH200
findings (§6) and hypothetical TPU-fleet classes used by the launcher.
``update_period_s`` / ``window_s`` are the characterised values; the
`instant`/`average` nvidia-smi query options become separate profiles where
the paper found they differ.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.sensor import SensorProfile

CATALOG: Dict[str, SensorProfile] = {}


def _add(p: SensorProfile) -> SensorProfile:
    CATALOG[p.name] = p
    return p


# --- data-centre parts -----------------------------------------------------
# A100: 25 ms window out of a 100 ms period on every driver (the paper's
# headline "only 25 % of runtime is sampled").
A100 = _add(SensorProfile("a100", update_period_s=0.100, window_s=0.025))
# H100 instant option: 25/100; average/normal option: 1 s running average.
H100_INSTANT = _add(SensorProfile("h100_instant", 0.100, 0.025))
H100_AVERAGE = _add(SensorProfile("h100_average", 0.100, 1.000))
# GH200: GPU reading 20/100, CPU reading 10/100; `instant` is module-scope.
GH200_GPU = _add(SensorProfile("gh200_gpu", 0.100, 0.020))
GH200_CPU = _add(SensorProfile("gh200_cpu", 0.100, 0.010))
GH200_MODULE_INSTANT = _add(SensorProfile(
    "gh200_module_instant", 0.100, 0.020, scope="module"))

# --- workstation / gaming ----------------------------------------------------
# Ampere (non-GA100) & Ada: pre-530 drivers => 1 s window; 530 => 100/100;
# post-530 default/average => 1 s again, new `instant` => 100/100.
RTX3090_PRE530 = _add(SensorProfile("rtx3090_pre530", 0.100, 1.000))
RTX3090_530 = _add(SensorProfile("rtx3090_530", 0.100, 0.100))
RTX3090_INSTANT = _add(SensorProfile("rtx3090_instant", 0.100, 0.100))
RTX3090_AVERAGE = _add(SensorProfile("rtx3090_average", 0.100, 1.000))
ADA = _add(SensorProfile("rtx4090_instant", 0.100, 0.100))
TURING = _add(SensorProfile("turing", 0.100, 0.100))

# --- Volta / Pascal: 10 ms window out of a 20 ms period ----------------------
VOLTA = _add(SensorProfile("v100", 0.020, 0.010))
PASCAL = _add(SensorProfile("p100", 0.020, 0.010))

# --- Kepler / Maxwell: logarithmic (capacitor-charging) transient ------------
KEPLER = _add(SensorProfile("kepler", 0.015, None, transient="logarithmic",
                            tau_s=0.8))
MAXWELL = _add(SensorProfile("maxwell", 0.100, None, transient="logarithmic",
                             tau_s=0.6))

# --- Fermi: estimation-based or unsupported ----------------------------------
FERMI2 = _add(SensorProfile("fermi2", 0.100, None, transient="estimation",
                            model_error=0.15))
FERMI1 = _add(SensorProfile("fermi1", supported=False))

# --- TPU-fleet classes (hardware adaptation; DESIGN.md §2) -------------------
# A part-time host-daemon sensor analogous to A100's 25/100 behaviour.
TPU_V5E_CHIP = _add(SensorProfile("tpu_v5e_chip", 0.100, 0.025))
# A host-level telemetry stream: module scope, 50/50 boxcar.
TPU_V5E_HOST = _add(SensorProfile("tpu_v5e_host", 0.050, 0.050,
                                  scope="module"))
# An averaged dashboard feed (1 s) like cloud monitoring exports.
TPU_V5E_DASH = _add(SensorProfile("tpu_v5e_dash", 1.000, 1.000))


def get(name: str) -> SensorProfile:
    try:
        return CATALOG[name]
    except KeyError:
        raise KeyError(f"unknown sensor profile '{name}'; "
                       f"available: {sorted(CATALOG)}") from None


# The three evaluation classes of §5 (cases 1–3).
CASE1 = RTX3090_INSTANT    # W == T   (100/100)
CASE2 = RTX3090_AVERAGE    # W >  T   (1000/100)
CASE3 = A100               # W <  T   (25/100) — the part-time case
