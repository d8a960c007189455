"""BENCHMARK.json and the files it names: each cell, configuration, traffic
kind and metric is found by its name, and the file keeps the contract's form."""

import importlib
import json
import re

import pytest

from lpbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lpbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["source"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_found_with_its_files(name):
    cell = spec.cell(name)
    assert cell.entry["chips"] == 1
    assert cell.config["name"] == cell.entry["config"]
    assert (spec.ROOT / next(c["file"] for c in BENCH["configs"]
                             if c["name"] == cell.entry["config"])).is_file()
    kind = cell.kind
    for fn in ("prepare", "warmup", "run", "Program"):
        assert hasattr(kind, fn)
    e2e = [m["name"] for m in cell.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer()
    assert set(cell.traffic["limits"]) >= {"status_mismatch", "obj_gap", "primal_viol"}


@pytest.mark.parametrize("metric", [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
                                    if m["name"] != "setup_s"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    mod = spec.reader(metric["name"])
    assert callable(mod.read)
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
    if "moves" in metric:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", CELLS)


def test_configs_are_used_and_their_files_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for c in BENCH["configs"]:
        assert c["file"].startswith("lpbench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}


@pytest.mark.parametrize("name", sorted(p.stem for p in (spec.HERE / "workloads").glob("*.json")
                                         if p.stem not in CELLS))
def test_an_undeclared_cell_runs_with_its_own_metrics(name):
    cell = spec.cell(name)
    assert cell.entry["chips"] == 1
    e2e = [m["name"] for m in cell.end_to_end()]
    assert e2e[0] == "setup_s" and len(e2e) >= 2 and cell.per_layer()
    for m in cell.end_to_end()[1:] + cell.per_layer():
        assert callable(spec.reader(m["name"]).read)


def test_traffic_kinds_import_without_the_program():
    for kind in {json.loads(p.read_text())["kind"] for p in (spec.HERE / "workloads").glob("*.json")}:
        importlib.import_module(f"lpbench.traffic.{kind}")
