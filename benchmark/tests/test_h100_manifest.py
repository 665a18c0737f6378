"""BENCHMARK.json against the contract its checker holds it to, and the
files each of its entries names."""

import importlib
import json
import os
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    n = 24  # the most cells a later PR may bring
    check_s = (2 + 14 * n) * (MAN["run_seconds"] + 60) + n * 180 + 1200
    assert check_s <= 43200
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_lines():
    entries = (MAN["configs"] + MAN["workloads"] + MAN["end_to_end"]
               + MAN["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[kind]]
        assert len(names) == len(set(names)), kind
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for e in MAN["configs"] + MAN["workloads"]:
        assert LINE.match(e["why"])
    for m in MAN["per_layer"]:
        assert LINE.match(m["layer"])
    for c in MAN["configs"]:
        assert LINE.match(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_cells_configs_and_chips():
    configs = {c["name"] for c in MAN["configs"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert used == configs                      # every config keeps a cell
    assert all(w["chips"] == 1 for w in MAN["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MAN["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"]
               if harness.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(harness.applies(m, w["name"]) for m in MAN["per_layer"])


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["moves"] != "setup_s"
        cells = m.get("workloads", [w["name"] for w in MAN["workloads"]])
        for cell in cells:
            assert harness.applies(moved, cell), (m["name"], cell)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    # One quantity, one layer name.
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    cell = harness.load_cell(MAN, w["name"])
    assert cell["config"]["name"] == w["config"]
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")
    assert set(cell["limits"]) == set(driver.CHECKS)
    for m in cell["per_layer"]:
        reader = importlib.import_module(
            f"benchmark.metrics.{m['name'].split('.')[0]}")
        assert callable(reader.read)


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("benchmark/configs/")
    with open(os.path.join(harness.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"] == []
    assert cfg["source"] == c["source"]
