"""BENCHMARK.json against the contract, and every piece found by name."""

import json
import re
import shutil

import pytest

from portbench import common, run

SPEC = common.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "-m", "portbench.run"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    workload = common.load_workload(cell)
    assert workload["config"] == entry["config"] and workload["chips"] == entry["chips"]
    assert workload["traffic"]["name"] == entry["traffic"] and workload["why"] == entry["why"]
    assert common.load_config(entry["config"])["name"] == entry["config"]
    assert callable(common.load_driver(workload["driver"]).run)
    e2e = run.cell_metrics(SPEC, cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = run.cell_metrics(SPEC, cell, "per_layer")
    assert per_layer and all(m["moves"] in e2e for m in per_layer.values())


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_reader_loads_by_name(metric):
    assert callable(common.load_metric(metric).read)
    assert common.load_metric(metric).read({}) is None  # nothing to read: nothing returned


def test_config_files_are_the_entries():
    for c in SPEC["configs"]:
        data = json.loads((common.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_an_added_file_is_found_without_an_edit(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(common.HERE, here, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    (here / "configs" / "added.json").write_text(json.dumps({"name": "added"}))
    (here / "workloads" / "added-cell.json").write_text(json.dumps({"config": "added"}))
    (here / "metrics" / "added_ms.x.py").write_text("def read(obs):\n    return obs.get('x')\n")
    (here / "drivers" / "added.py").write_text("def run(ctx):\n    return 7\n")
    assert common.load_config("added", here)["name"] == "added"
    assert common.load_workload("added-cell", here)["config"] == "added"
    assert common.load_metric("added_ms.x", here).read({"x": 3}) == 3
    assert common.load_driver("added", here).run(None) == 7
