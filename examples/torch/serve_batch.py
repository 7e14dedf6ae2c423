"""Batched serving on the card: continuous batching over a reduced model
(the port of ``examples/serve_batch.py``).

    PYTHONPATH=src python examples/torch/serve_batch.py [--device cpu]

The weights are drawn from a ``torch.Generator`` seeded 1 on the device.
"""
import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServingEngine


def run(device="cuda"):
    """Serve 10 requests and print; returns the requests the engine
    finished."""
    dev = resolve_device(device)
    cfg = get_config("gemma2-2b", reduced=True)
    params = api.init_params(1, cfg, dev)
    eng = ServingEngine(cfg, params, n_slots=4, max_seq=96, device=dev)

    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(1, cfg.vocab, size=6).astype(np.int32),
                    max_new_tokens=12) for i in range(10)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run(max_ticks=5_000)
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in reqs)
    print(f"{sum(r.done for r in reqs)}/{len(reqs)} done, "
          f"{toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s)")
    for r in reqs[:4]:
        print(f"  req{r.request_id}: prompt={list(r.prompt)} "
              f"-> {r.generated}")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
