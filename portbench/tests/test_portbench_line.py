"""The result line's keys, and the refusals of ``python3 -m
portbench.run``."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness, run


@pytest.mark.parametrize("workload", ["fleet100k-1khz.aligned",
                                      "fleet100k-1khz.shuffled",
                                      "audit1m-mix.batch"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(small_cell, workload, trace):
    cell = small_cell(workload, trace=trace)
    out = harness.driver(cell.config["system"]).run(cell, 0.0)
    line = json.loads(json.dumps(harness.result_line(cell, out)))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if trace else []
    assert list(line) == keys + ["checks"]      # the numbers compared last
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "fleet100k-1khz.aligned", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ holds no
    program: the run fails before it prints a result."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "fleet100k-1khz.aligned", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.parametrize("modules,bad", [
    (["repro_torch", "repro_torch.core", "torch", "numpy"], []),
    (["repro.core", "repro_torch"], ["repro"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"])])
def test_forbidden_modules_by_whole_top_level_name(modules, bad):
    assert harness.forbidden_loaded(modules) == bad
