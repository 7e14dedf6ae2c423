"""Cells, traffic mixes and per-layer metrics are found by name from
their files: a new one is a new file and an entry, with no code edit."""
import json
import shutil

from portbench import harness


def test_new_config_mix_and_metric_from_files_alone(tmp_path, small_cell):
    root = tmp_path / "checkout"
    shutil.copytree(harness.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = harness.benchmark()
    # a new configuration, mix, limits and per-layer metric: files only
    conf = harness.read_json(harness.PKG / "configs" / "fleet100k-1khz.json")
    conf["scenario_mix"] = {"training": 1.0}
    (root / "portbench/configs/fleet-train.json").write_text(
        json.dumps(conf))
    (root / "portbench/traffic/two-ticks.json").write_text(json.dumps(
        {"layout": "grid", "pool_ticks": 2, "warmup_slabs": 1,
         "trace_slabs": 3}))
    (root / "portbench/limits/fleet-train.two-ticks.json").write_text(
        (harness.PKG / "limits/fleet100k-1khz.aligned.json").read_text())
    (root / "portbench/metrics/traffic_calls.py").write_text(
        "def read(ctx):\n"
        "    return float(len(ctx.trace.spans.get('traffic', [])))\n")
    bench["configs"].append({"name": "fleet-train", "source": "test",
                             "file": "portbench/configs/fleet-train.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "fleet-train.two-ticks",
                               "config": "fleet-train",
                               "traffic": "two-ticks", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("fleet-train.two-ticks")
    bench["per_layer"].append({"name": "traffic_calls", "unit": "calls",
                               "better": "lower", "source": "program_span",
                               "layer": "traffic", "moves":
                               "ingest_samples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = small_cell("fleet-train.two-ticks", trace=True, root=root)
    assert cell.traffic["pool_ticks"] == 2
    assert cell.config["scenario_mix"] == {"training": 1.0}
    names = [m["name"] for m in cell.per_layer]
    assert "traffic_calls" in names and "ingest_call_ms" not in names
    out = harness.driver(cell.config["system"]).run(cell, 0.0)
    line = harness.result_line(cell, out)
    assert line["correct"] is True
    assert line["metrics"]["traffic_calls"]["value"] >= 3
    assert line["metrics"]["traffic_calls"]["unit"] == "calls"


def test_metrics_apply_by_their_workloads():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"], seed=1, seconds=1,
                                 trace=False)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert harness.reader(m["name"]) is not None
