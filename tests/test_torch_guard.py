"""Guards on the port's boundaries.

* ``repro_torch`` and ``chip_smoke.py`` import neither jax nor the JAX
  package ``repro``;
* entry points run on the card unless the caller asks for the CPU, and
  never fall back to it on their own;
* the kernels are built for Hopper (``sm_90a``), and each takes its
  output pointers in the field order of its wrapper's output tuple.
"""
import ast
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fleet_engine import SensorBank  # noqa: E402
from repro_torch.core.stream import MonitorService  # noqa: E402
from repro_torch.engine_backend import torch_backend as tb  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stream_ingest import stream_ingest  # noqa: E402
from repro_torch.kernels.stream_ingest_grid import (  # noqa: E402
    stream_ingest_grid)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_of_jax_or_the_reference(path):
    assert path.exists(), path
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MonitorService(4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SensorBank.from_catalog("a100", n=4)
    MonitorService(4, device="cpu")      # the explicit request works


def test_kernel_wrappers_never_run_the_plain_version_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises; the
    plain version is not taken for it."""
    meta = torch.device("meta")
    f64 = dict(dtype=torch.float64, device=meta)
    z = torch.zeros(3, **f64)
    with pytest.raises(ValueError, match="cpu or cuda"):
        stream_ingest(z, z, *([torch.zeros(3, dtype=torch.int64,
                                           device=meta)] * 4),
                      *([z] * 13))
    with pytest.raises(ValueError, match="cpu or cuda"):
        stream_ingest_grid(z, torch.zeros((2, 3), **f64), *([z[:2]] * 13))


def test_kernel_build_needs_nvcc_and_says_so(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_kernels_are_built_for_hopper(name):
    cmd = " ".join(_build.nvcc_command(name, pathlib.Path("lib.so")))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert (_build.CSRC / _build.SOURCES[name]).exists()
    assert _build.library_path(name).name.startswith(f"lib{name}-")


@pytest.mark.parametrize("name, struct, outputs", [
    ("stream_ingest", "IngestArgs", tb.IngestOut),
    ("stream_ingest_grid", "GridArgs", tb.IngestGridOut)])
def test_kernel_argument_struct_ends_with_the_output_fields(name, struct,
                                                            outputs):
    """The wrapper passes ``inputs + list(out)`` as one pointer array, so
    the source's argument struct must list the outputs last, in the
    tuple's field order, and count every pointer in kNumPointers."""
    src = (_build.CSRC / _build.SOURCES[name]).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    fields = re.findall(r"\*\s*(\w+);", body)
    assert tuple(fields[-len(outputs._fields):]) == outputs._fields
    n = int(re.search(r"kNumPointers = (\d+);", src).group(1))
    assert n == len(fields)
