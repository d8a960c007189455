"""Find a cell, its configuration, its traffic and its metrics by name.

`BENCHMARK.json` at the root of the checkout lists the cells and metrics;
each cell's traffic and limits are in `lpbench/workloads/<cell>.json`, each
configuration in `lpbench/configs/<config>.json`, each traffic kind's loop
in `lpbench/traffic/<kind>.py`, and each metric's reader in
`lpbench/metrics/<metric>.py`.  A new cell, configuration or metric is new
files and a new entry; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict       # its line of BENCHMARK.json's workloads
    traffic: dict     # lpbench/workloads/<cell>.json
    config: dict      # lpbench/configs/<config>.json
    benchmark: dict   # the whole of BENCHMARK.json

    @property
    def kind(self):
        return importlib.import_module(f"lpbench.traffic.{self.traffic['kind']}")

    def end_to_end(self) -> list[dict]:
        return [m for m in self.benchmark["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.benchmark["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in moved else [])]


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def cell(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json; or, for a cell that it does not
    declare (kept for diagnosis until the program can pass it), the entry
    and the metrics that the cell's own file gives, with `setup_s`."""
    bench = _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    path = HERE / "workloads" / f"{name}.json"
    if entry is None and not path.is_file():
        raise KeyError(f"no workload {name!r} in BENCHMARK.json or {path}")
    traffic = _json(path)
    if entry is None:
        entry = {"name": name, "config": traffic["config"], "traffic": traffic["traffic"],
                 "chips": 1, "why": traffic["why"]}
        setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
        bench = {"workloads": [entry], "end_to_end": setup + traffic["end_to_end"],
                 "per_layer": traffic["per_layer"]}
    for key in ("config", "traffic"):
        if traffic[key] != entry[key]:
            raise ValueError(f"{name}: {key} {traffic[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    config = _json(HERE / "configs" / f"{entry['config']}.json")
    return Cell(name, entry, traffic, config, bench)


def reader(metric: str):
    """The module `lpbench/metrics/<metric>.py`, whose `read(ctx)` gives the
    metric's value, or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"lpbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
