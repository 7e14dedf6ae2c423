"""End to end on the card: train a reduced LM for a few hundred
steps with fault-tolerant checkpointing and first-class energy accounting
(the port of ``examples/train_mini_lm.py``).

    PYTHONPATH=src python examples/torch/train_mini_lm.py [--steps 200]
        [--device cpu] [--ckpt-dir DIR]

Kill it mid-run and re-run: it resumes exactly (optimizer, data stream and
the energy ledger all survive the restart) from the checkpoints in
``--ckpt-dir`` (default ``build/examples/mini_lm`` in the checkout).
"""
import argparse
import os

from repro_torch._device import resolve_device
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.step import TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT_DIR = os.path.join(ROOT, "build", "examples", "mini_lm")


def run(steps=200, ckpt_dir=CKPT_DIR, device="cuda"):
    """Train and print; returns :func:`run_training`'s dict."""
    dev = resolve_device(device)
    cfg = get_config("olmo-1b", reduced=True).replace(
        n_layers=4, d_model=128, d_ff=512)          # ~100M-class reduced
    shape = ShapeCell("mini", seq_len=128, global_batch=16, mode="train")
    tcfg = TrainConfig(
        microbatches=2,
        optim=AdamWConfig(lr_peak=3e-3, warmup_steps=20, total_steps=steps))
    lcfg = LoopConfig(total_steps=steps, ckpt_every=50, log_every=20)
    out = run_training(cfg, shape, tcfg, lcfg, ckpt_dir=ckpt_dir,
                       device=dev)
    print(f"\nloss {out['losses'][0]:.3f} -> {out['final_loss']:.3f} "
          f"over {len(out['losses'])} steps")
    print("energy summary:", out["energy"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.steps, args.ckpt_dir, resolve_device(args.device))


if __name__ == "__main__":
    main()
