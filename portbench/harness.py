"""portbench's core: finds a cell's configuration, traffic mix and
per-layer metrics by the names in ``BENCHMARK.json``, runs the cell's
driver and assembles the result line.

A configuration is ``configs/<config>.json``; its ``system`` names the
general driver (``drivers/<system>.py``) that serves every configuration
and mix of that system.  A traffic mix is ``traffic/<traffic>.json``, the
parameters that driver's generator reads.  A per-layer metric is
``metrics/<metric>.py``, whose ``read(ctx)`` takes the metric from the
traced stretch (``ctx.trace``, a :class:`~portbench.trace.TraceData`) and
the driver's counts (``ctx.info``), or returns None when it finds nothing
to read.  New cells, mixes and metrics are new files.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules, compared as
    whole names (``repro_torch`` is not ``repro``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names.intersection(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """One cell as a run sees it."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    seed: int
    seconds: float
    trace: bool
    device: Any = "cuda"
    root: Path = ROOT

    def file(self, kind: str, name: str, suffix: str) -> Path:
        """``portbench/<kind>/<name><suffix>`` under the cell's checkout."""
        return self.root / "portbench" / kind / f"{name}{suffix}"


def _applies(metric: dict, cell_name: str) -> bool:
    ws = metric.get("workloads")
    return ws is None or cell_name in ws


def find_cell(bench: dict, workload: str, *, seed: int, seconds: float,
              trace: bool, device="cuda", overrides: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``bench`` with its configuration and mix
    read from their files; ``overrides`` replaces top-level keys of the
    configuration (the tests run a cell at a size the CPU holds)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload '{workload}'; have {sorted(cells)}")
    w = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = dict(read_json(root / confs[w["config"]]["file"]))
    conf.update(overrides or {})
    traffic = read_json(root / "portbench" / "traffic"
                        / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if ("workloads" in m and workload in m["workloads"])
                 or ("workloads" not in m and m["moves"] in e2e_names)]
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]), conf,
                traffic, e2e, per_layer, int(seed), float(seconds),
                bool(trace), device, Path(root))


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of the per-layer metric ``name``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(system: str):
    return importlib.import_module(f"portbench.drivers.{system}")


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric reads: the traced stretch and the
    driver's counts for it."""

    trace: Any
    info: Dict[str, Any]


@dataclasses.dataclass
class Outcome:
    """What a driver hands back after the window has closed and the
    output check has run."""

    attempted: int
    failed: int
    metrics: Dict[str, float]            # end-to-end, by name
    checks: Dict[str, tuple]             # name -> (value, limit)
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    trace: Optional[TraceContext] = None


def passed(checks: Dict[str, tuple]) -> bool:
    """Every number compared is finite and within its limit."""
    return all(v == v and v <= lim for v, lim in checks.values())


def result_line(cell: Cell, out: Outcome) -> dict:
    """The result object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
    the numbers compared beside their limits."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    device = {"platform": "gpu" if out.device_kind != "cpu" else "cpu",
              "kind": out.device_kind, "count": out.device_count,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if cell.trace:
        ctx = out.trace
        metrics = {}
        for m in cell.per_layer:
            val = (reader(m["name"], cell.root)(ctx) if ctx is not None
                   else None)
            if val is not None:
                metrics[m["name"]] = {"value": float(val),
                                      "unit": units[m["name"]]}
        if ctx is not None:
            device["busy_s"] = ctx.trace.busy_s()
            device["window_s"] = ctx.trace.window_s
    else:
        metrics = {m["name"]: {"value": float(out.metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": passed(out.checks), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if cell.trace and out.trace is not None:
        line["breakdown"] = out.trace.trace.breakdown()
    line["checks"] = {k: {"value": float(v), "limit": float(lim)}
                      for k, (v, lim) in out.checks.items()}
    return line


def check_lines(checks: Dict[str, tuple]) -> List[str]:
    """One line a number compared: name, value, limit, verdict."""
    return [f"check {k}: {v!r} (limit {lim!r}) "
            f"{'ok' if v == v and v <= lim else 'FAILED'}"
            for k, (v, lim) in checks.items()]


def limits(cell: Cell) -> dict:
    """The limit of each number the cell's output check compares."""
    return read_json(cell.file("limits", cell.name, ".json"))


def trace_path(cell: Cell) -> Path:
    return cell.file("out", f"trace-{cell.name}", ".json")
