"""Sweep the tile of ``rglru_scan_bwd``'s TMA ring on an NVIDIA GPU.

    python3 tools/rglru_bwd_sweep.py [--shape B S D] [--reps N]

Builds copies of ``csrc/rglru_scan_bwd_tma.cu`` with other consumer
warps a block (``kConsumers``, 32 channels each), steps a tile
(``kSteps``) and stages (``kStages``) into ``build/rglru_bwd_sweep/``,
one ``nvcc`` each, all started together, with the build's own flags.  A
copy marked ``reads`` neither writes nor stores its output tiles: the
ring's loads and the chain alone.  Then, at ``--shape`` (default
recurrentgemma-9b's training shape [2, 3000, 4096] f32; inputs made from
a seed, h from the forward kernel), it times the wrapper's two routes
and every copy, each twice in turn (the list, then the list again),
checks each full copy bitwise against the thread-loads kernel, and
prints the ms and the share of the byte bound (a, h, dh read once, da
and du written once, at 3.35 TB/s) of each.  Times are CUDA events
around repeated calls behind a device-side sleep (``chip_smoke.py``'s
``time_ms``).  Prints the card's name and power limit first and a JSON
object last.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12

#: (consumer warps, steps a tile, stages, mode): the kernel's own tile
#: first; "reads" drops the output tiles' writes and stores
VARIANTS = [(1, 16, 3, "full"), (1, 16, 2, "full"), (1, 16, 4, "full"),
            (1, 16, 6, "full"), (1, 8, 4, "full"), (1, 24, 3, "full"),
            (1, 32, 2, "full"), (1, 32, 4, "full"), (1, 64, 2, "full"),
            (2, 16, 3, "full"), (4, 16, 3, "full"), (2, 32, 3, "full"),
            (1, 16, 3, "reads"), (1, 32, 4, "reads")]


def variant_source(src: str, w: int, t: int, k: int, mode: str) -> str:
    """The kernel's source with the tile (w, t, k); without its output
    tiles' writes and stores where ``mode`` is "reads"."""
    subs = [("constexpr int kConsumers = ", w), ("constexpr int kSteps = ", t),
            ("constexpr int kStages = ", k)]
    lines = src.splitlines()
    for i, line in enumerate(lines):
        for head, value in subs:
            if line.startswith(head):
                lines[i] = f"{head}{value};{line.split(';', 1)[1]}"
        if mode == "reads":
            body = line.strip()
            if body.startswith(("odu[r * kChannels] =",
                                 "oda[r * kChannels] =")):
                lines[i] = line.replace(body[:3], "if (g == 1234.5f) " +
                                        body[:3], 1)
            if body.startswith("tma_store(&tm_d"):
                lines[i] = ""
    out = "\n".join(lines) + "\n"
    for head, value in subs:
        assert f"{head}{value};" in out, head
    return out


def build(variants):
    """Each variant's library under build/rglru_bwd_sweep/; returns
    {variant: (launch function, ptxas register line)}."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "rglru_bwd_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / _build.SOURCES["rglru_scan_bwd_tma"]).read_text()
    procs = {}
    for v in variants:
        name = "v_" + "_".join(map(str, v))
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(src, *v))
        so = out / f"lib{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(so), str(cu)]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for v, (proc, so) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{text}")
        regs = " ".join(ln.split(":", 1)[1].strip() for ln in
                        text.splitlines() if "registers" in ln)
        fn = ctypes.CDLL(str(so)).rglru_scan_bwd_tma_launch
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)]
                       + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[v] = (fn, regs)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=[2, 3000, 4096])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("rglru_bwd_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as krs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build(["rglru_scan", "rglru_scan_bwd", "rglru_scan_bwd_tma"])
    libs = build(VARIANTS)
    shape = tuple(args.shape)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    a = torch.sigmoid(torch.randn(shape, generator=gen, device=dev))
    u, dh = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
    h = krs.rglru_scan(a, u)
    want = (torch.empty_like(a), torch.empty_like(a))
    krs._bwd_launch_route(krs.THREAD_LOADS, a, h, dh, *want)
    bound = 5 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call(fn, outs):
        ptrs = (ctypes.c_void_p * 5)(*[x.data_ptr()
                                       for x in (a, h, dh, *outs)])
        rc = fn(ptrs, *shape, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    runs = {}
    rows = [(r, None) for r in krs.BWD_KERNELS] + list(libs.items())
    for _ in range(2):
        for key, lib in rows:
            outs = (torch.empty_like(a), torch.empty_like(a))
            if lib is None:
                fn = (lambda r=key: krs._bwd_launch_route(r, a, h, dh, *outs))
            else:
                fn = (lambda f=lib[0]: call(f, outs))
            fn()
            torch.cuda.synchronize()
            same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(outs, want))
            runs.setdefault(key, dict(ms=[], bitwise=same,
                                      ptxas=lib[1] if lib else ""))
            runs[key]["ms"].append(time_ms(fn, args.reps))
    for key, r in runs.items():
        label = key if isinstance(key, str) else (
            "kConsumers={} kSteps={} kStages={} {}".format(*key))
        print(f"{label}: {' / '.join(f'{t:.4f}' for t in r['ms'])} ms, "
              f"{bound / min(r['ms']):.1%} of the bound {bound:.4f} ms; "
              f"bitwise the thread-loads kernel: {r['bitwise']}; "
              f"{r['ptxas']}", flush=True)
        check = r["bitwise"] or (not isinstance(key, str)
                                 and key[3] == "reads")
        if not check:
            print(f"rglru_bwd_sweep: {label} is not bitwise", file=sys.stderr)
            return 1
    print(json.dumps(dict(card=smi, shape=list(shape), bound_ms=bound,
                          runs={str(k): v for k, v in runs.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
