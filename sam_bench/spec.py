"""Read `BENCHMARK.json` and the files of one cell, by the names in it."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import List

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # {number: limit} of the correctness check
    end_to_end: List[dict]  # BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(wl)}")
    w = wl[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    limits = load_json(os.path.join(PKG, "limits", f"{name}.json"))["limits"]
    return Cell(name, int(w["chips"]), w["config"], load_json(os.path.join(root, conf["file"])),
                load_json(os.path.join(PKG, "traffic", f"{w['traffic']}.json")),
                limits, e2e, per_layer)


def module(kind: str, name: str):
    """sam_bench.<kind>.<name>: a generator, runner or reference module."""
    if not NAME.match(name) or "." in name:
        raise ValueError(f"bad {kind} name {name!r}")
    return importlib.import_module(f"sam_bench.{kind}.{name}")


def metric_reader(name: str):
    """The reader of per-layer metric `name`: metrics/<name>.py, loaded by
    path (a metric name may hold dots)."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"sam_bench.metrics._{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
