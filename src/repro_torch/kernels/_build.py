"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
:mod:`ctypes`.  Building happens on first use, so a fresh checkout needs
no build step; the libraries go to ``build/kernels/`` at the root of the
checkout, named by a hash of their sources and flags, so an unchanged
kernel is never rebuilt.  :func:`build` compiles several sources at once,
one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: kernel name -> its CUDA source in ``csrc/`` (headers: every ``*.cuh``)
SOURCES = {
    "stream_ingest": "stream_ingest.cu",
    "stream_ingest_grid": "stream_ingest_grid.cu",
    "log_filter": "log_filter.cu",
    "step_integrate": "step_integrate.cu",
    "fma_chain": "fma_chain.cu",
    "rglru_scan": "rglru_scan.cu",
    "rglru_scan_bwd": "rglru_scan_bwd.cu",
    "rglru_scan_bwd_tma": "rglru_scan_bwd_tma.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_tc": "flash_attention_tc.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "flash_attention_bwd_tc": "flash_attention_bwd_tc.cu",
}

# -fmad=false keeps every product separately rounded, as the plain
# PyTorch versions compute it, so elementwise outputs match bitwise
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / SOURCES[name]] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def nvcc_command(name: str, out: Path, nvcc: Optional[str] = None) -> list:
    """The command line that builds kernel ``name`` into ``out``."""
    return [nvcc or "nvcc", *NVCC_FLAGS, "-o", str(out),
            str(CSRC / SOURCES[name])]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns each
    kernel's build seconds (0.0 when it was already built); the
    compiler's output, ``ptxas`` register counts included, is kept in
    ``build/kernels/<name>.log``."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".tmp{os.getpid()}")
        log = open(BUILD_DIR / f"{n}.log", "w")
        procs[n] = (subprocess.Popen(nvcc_command(n, tmp, nvcc), stdout=log,
                                     stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        try:
            rc = proc.wait()
        finally:
            log.close()
        secs[n] = time.perf_counter() - t0
        if rc != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{logs}")
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
