"""Serving launcher of the port: batched decode with slot-based continuous
batching (a port of :mod:`repro.launch.serve`, with its arguments,
defaults and printed lines).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --requests 8 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
        --arch qwen2-moe-a2.7b

``--arch`` offers every architecture of the registry; as in the
reference, an encoder–decoder or ``embeds`` architecture (seamless-m4t,
qwen2-vl) is refused with "CLI serving demo targets token-LM archs".
The model runs on the card unless ``--torch-device cpu``.  ``--reduced``
is on by default, as in the reference; ``--no-reduced`` serves the full
configuration, which the reference's flag (``store_true`` with a default
of True) cannot ask for.  Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServingEngine


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the arch's REDUCED config (default); "
                         "--no-reduced serves the full one")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.encdec or cfg.input_mode == "embeds":
        raise SystemExit("CLI serving demo targets token-LM archs")
    params = api.init_params(0, cfg, args.torch_device)
    eng = ServingEngine(cfg, params, n_slots=args.slots,
                        max_seq=args.max_seq, device=args.torch_device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab, size=8).astype(np.int32),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=10_000)
    dt = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.generated) for r in reqs)
    print(f"served {done}/{len(reqs)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s), {eng.ticks} ticks")
    for r in reqs[:3]:
        print(f"  req{r.request_id}: {list(r.prompt)} -> {r.generated}")


if __name__ == "__main__":
    main()
