"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is a
file of its own that the harness finds by name, and each entry keeps to the
file's format (names, units, bounds, keys)."""

import importlib
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert NAME.match(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    from cp360_tpu_torch.config import Config

    Config(**cfg["config"])  # every key is one of the port's Config fields


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert NAME.match(cell) and NAME.match(entry["traffic"]) and entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200
    run = harness.load_run(cell, 1, 1.0, False, False)
    assert {k: run.cell[k] for k in ("config", "traffic", "chips", "why")} == \
        {k: entry[k] for k in ("config", "traffic", "chips", "why")}
    driver = importlib.import_module(f"benchmark.drivers.{run.traffic['driver']}")
    assert all(callable(getattr(driver, hook, None))
               for hook in ("setup", "window", "release", "check"))
    assert run.cell["limits"]
    wanted = harness.cell_metrics(BENCH, cell)
    names = {m["name"] for m in wanted["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert wanted["per_layer"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_reads_nothing_from_nothing(metric):
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    read = harness.load_metric_reader(metric["name"])
    run = harness.load_run(metric["workloads"][0], 1, 1.0, True, False)
    assert read(harness.MetricContext(run, None)) is None
