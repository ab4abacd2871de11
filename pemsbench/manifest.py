"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; a metric names its reader.
Each is a file under this folder whose path follows from the name alone, so
a later cell, mix or metric is added as files and manifest entries, with no
edit to the harness.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config_file(manifest: dict, name: str) -> dict:
    """The configuration as it is run: the file its manifest entry names."""
    with open(ROOT / config_entry(manifest, name)["file"]) as f:
        return json.load(f)


def traffic_path(mix: str) -> Path:
    return HERE / "traffic" / f"{mix}.json"


def traffic_file(mix: str) -> dict:
    with open(traffic_path(mix)) as f:
        return json.load(f)


def reader(name: str):
    """The module of metric ``name``: ``read(record)`` returns its value, or
    None where the run holds nothing for it to read."""
    spec = importlib.util.spec_from_file_location(
        f"pemsbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system(name: str):
    """The module of system ``name`` (``systems/<name>.py``)."""
    return importlib.import_module(f"pemsbench.systems.{name}")


def metrics_for(manifest: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced.  A metric without a
    ``workloads`` key is reported in every cell; a per-layer one then in
    every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in manifest["end_to_end"] if _in(m, cell_name)]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def _in(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]

