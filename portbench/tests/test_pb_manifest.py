"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, and a file for every configuration, mix, metric and limit."""
import json
import os
import re

import pytest

import scenes
from traffic import load_traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    MANIFEST = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _all_metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == KEYS
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.match(p) for p in MANIFEST["paths"])
    assert all(".." not in p and not p.startswith("/") for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32 and all(TEXT.match(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert scenes.load_config(entry["name"])["name"] == entry["name"]
    assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda e: e["name"])
def test_workloads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and TEXT.match(cell["why"])
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    assert load_traffic(cell["traffic"])["name"] == cell["traffic"]
    limits = os.path.join(ROOT, "portbench", "limits", f"{cell['name']}.json")
    assert os.path.exists(limits)
    e2e = [m for m in MANIFEST["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any("workloads" not in m or cell["name"] in m["workloads"]
               for m in MANIFEST["per_layer"])


def test_cells_are_unique():
    names = [c["name"] for c in MANIFEST["workloads"]]
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(set(names)) == len(names) and len(set(pairs)) == len(pairs)
    four = sum(c["chips"] == 4 for c in MANIFEST["workloads"])
    assert four <= max(1, len(names) // 4)


@pytest.mark.parametrize("metric", _all_metrics(), ids=lambda m: m["name"])
def test_metrics(metric):
    per_layer = metric in MANIFEST["per_layer"]
    keys = {"name", "unit", "better", "source"} | (
        {"layer", "moves"} if per_layer else {"bound"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", f"{metric['name']}.py"))
    cells = {c["name"] for c in MANIFEST["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if per_layer:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert TEXT.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_metric_names_are_unique():
    names = [m["name"] for m in _all_metrics()]
    assert len(set(names)) == len(names)
