"""The dry run's attribution (``launch/opcount.py``'s sites) and its two
tools (``tools/torch_top_dots.py``, ``tools/torch_attribute_collectives.py``),
at ``REDUCED`` on the ``tiny2x2`` mesh over four placeholder ranks.

* The sites' dot FLOPs add up exactly to the traced dot FLOPs, and their
  bytes exactly to each collective kind's total.
* With attribution on, every total of the counter equals the total with
  it off (the anomaly mode it turns on adds no op), and a process's first
  trace of a cell counts what its later ones count.
* A site is a model's frame (``models/…py:line function``), the package's
  where no model frame exists (the optimizer), and carries its autograd
  node's name where the engine ran it in the backward.
* Both tools exit 0 and print their ``TOTAL`` lines; their ``--json``
  totals equal the trace's.
"""
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_shape  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_process_group  # noqa: E402
from repro_torch.launch.opcount import COLLECTIVES  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (arch, shape): a train step with grouped MoE dispatch and a decode
#: step (its own layout); gemma2-2b's dense train step is the tools' cell
CELLS = [("granite-moe-3b-a800m", "train_4k"), ("olmo-1b", "decode_32k")]
SITE = re.compile(r"^(models|optim|train|launch)/\w+\.py:\d+ \S+"
                  r"( \[\w+\])?$")


def _trace(arch, shape, attribute):
    with fake_process_group(math.prod(dryrun.MESHES["tiny2x2"][0])):
        return dryrun.trace_cell(get_config(arch, reduced=True),
                                 get_shape(shape), dryrun._mesh("tiny2x2"),
                                 attribute=attribute)["counter"]


@pytest.fixture(scope="module", params=CELLS, ids=["-".join(c)
                                                   for c in CELLS])
def traced(request):
    """The cell traced with attribution off (the process's first trace of
    it), off again, and on."""
    arch, shape = request.param
    return (_trace(arch, shape, False), _trace(arch, shape, False),
            _trace(arch, shape, True))


def _totals(c):
    return (c.dot_flops, c.dot_flops_by_dtype, c.collectives,
            c.bytes_accessed, c.peak_bytes, c.live_bytes, c.ops)


def test_a_cell_counts_the_same_in_a_processs_first_trace(traced):
    """DTensor's strategy search runs ops of its own the first time an op
    meets a mesh (then caches it): not a rank's work, so not counted."""
    first, again, _ = traced
    assert _totals(first) == _totals(again)


def test_sites_add_up_to_the_totals(traced):
    _, _, on = traced
    assert on.dot_flops > 0
    assert sum(on.dot_sites.values()) == on.dot_flops
    for kind in COLLECTIVES:
        got = sum(b for (k, _, _), b in on.collective_sites.items()
                  if k == kind)
        assert got == on.collectives.bytes_by_kind[kind], kind
        calls = sum(on.site_calls[key] for key in on.collective_sites
                    if key[0] == kind)
        assert calls == on.collectives.count_by_kind[kind], kind
    assert sum(on.site_calls[k] for k in on.dot_sites) == sum(
        n for op, n in on.ops.items()
        if any(op == o for o, _ in on.dot_sites))


def test_attribution_changes_no_total(traced):
    _, off, on = traced
    assert not off.dot_sites and not off.collective_sites
    assert _totals(on) == _totals(off)


def test_sites_name_the_models_frames(traced):
    _, _, on = traced
    sites = [s for _, s in on.dot_sites] + [s for _, _, s in
                                            on.collective_sites]
    assert all(SITE.match(s) for s in sites), [s for s in sites
                                                if not SITE.match(s)]
    # the products are attributed to the layers, not the einsum wrappers
    assert not any(re.search(r"layers\.py:\d+ _?einsum", s) for s in sites)
    flops = {}
    for (_, s), n in on.dot_sites.items():
        flops[s.startswith("models/")] = flops.get(
            s.startswith("models/"), 0) + n
    assert flops[True] == on.dot_flops


def test_the_backward_carries_the_forwards_site():
    on = _trace("gemma2-2b", "train_4k", True)
    backward = {s for _, s in on.dot_sites if s.endswith("]")}
    assert backward and all(s.startswith("models/") for s in backward)
    forward = {s for _, s in on.dot_sites if not s.endswith("]")}
    assert {s.rsplit(" [", 1)[0] for s in backward} <= forward


def _tool(name, *args, env=None):
    return subprocess.run(
        [sys.executable, str(ROOT / "tools" / name), *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {})))


@pytest.mark.parametrize("tool, total", [
    ("torch_top_dots.py", r"TOTAL \d\.\d{3}e\+\d+ dot flops/device"),
    ("torch_attribute_collectives.py", r"TOTAL \d+\.\d\d GB/device")])
def test_the_tools_print_their_totals(tool, total, tmp_path):
    out = tmp_path / "sites.json"
    r = _tool(tool, "gemma2-2b", "train_4k", "--reduced", "--json",
              str(out), env={"REPRO_DRYRUN_DEVICES": "4"})
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert re.fullmatch(total, lines[0]), lines[:2]
    rows = lines[1:]
    assert 0 < len(rows) <= (18 if "dots" in tool else 25)
    want = _trace("gemma2-2b", "train_4k", False)
    got = json.loads(out.read_text())
    if "dots" in tool:
        assert got["total"] == got["dot_flops"] == want.dot_flops
        assert lines[0] == f"TOTAL {want.dot_flops:.3e} dot flops/device"
        assert all(re.match(r" *\d\.\d{3}e\+\d+ \( *\d+\.\d%\) x *\d+ "
                            r"\S+ \| ", row) for row in rows), rows
    else:
        assert got["bytes_by_kind"] == want.collectives.bytes_by_kind
        assert got["total"] == want.collectives.total_bytes
        assert all(re.match(r" *\d+\.\d{3} GB  x *\d+ [a-z-]+ +\S+ \| ",
                            row) for row in rows), rows


def test_the_tools_refuse_a_rank_count_of_another_mesh():
    r = _tool("torch_top_dots.py", "gemma2-2b", "train_4k", "--reduced",
              "--mesh", "tiny", env={"REPRO_DRYRUN_DEVICES": "256"})
    assert r.returncode == 2 and "REPRO_DRYRUN_DEVICES=256" in r.stderr
