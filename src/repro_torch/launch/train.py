"""Training launcher of the port (a port of :mod:`repro.launch.train`,
with its arguments, defaults and printed lines).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 8 --seq-len 2048 --batch 4 --sensor h100_instant
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --steps 50 --ckpt-dir build/ck --torch-device cpu

The model trains on the card unless ``--torch-device cpu``.  As in the
reference, ``--reduced`` is off by default, so the default is the arch's
full configuration.  Re-running the same command after a kill resumes
from the latest complete checkpoint in ``--ckpt-dir`` (parameters,
optimizer state, loader step and energy ledger).  Every run prints its
final loss, its straggler count and the energy ledger's summary (naive
and corrected joules of the simulated sensor, not the card's draw).
"""
from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, Optional, Sequence

from repro_torch.configs.base import ShapeCell, get_shape
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import TrainConfig


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Parse ``argv``, train, print the three lines; returns
    :func:`run_training`'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--sensor", default="tpu_v5e_chip")
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    shape = get_shape(args.shape) if args.shape else ShapeCell(
        "cli", args.seq_len, args.batch, "train")
    tcfg = TrainConfig(
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
        optim=AdamWConfig(lr_peak=args.lr,
                          warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps))
    lcfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      sensor_profile=args.sensor)
    out = run_training(cfg, shape, tcfg, lcfg,
                       ckpt_dir=args.ckpt_dir or None,
                       device=args.torch_device)
    print("final_loss:", out["final_loss"])
    print("stragglers:", out["stragglers"])
    print("energy:", out["energy"])
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    main()
