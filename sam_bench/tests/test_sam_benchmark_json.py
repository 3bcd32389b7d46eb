"""BENCHMARK.json keeps the contract's shape and characters, and every name
in it finds its files under sam_bench/."""

import json
import os
import re

import pytest

from sam_bench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= int(BENCH["run_seconds"]) <= 51
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    all_names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
                 for x in BENCH[g]]
    assert len(set(all_names)) == len(all_names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = spec.cell(BENCH, cell)
    assert c.config["name"] == c.config_name
    spec.module("generators", c.config["generator"])
    spec.module("reference", c.config["reference"])
    spec.module("runners", c.traffic["runner"])
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert set(c.limits) == {"iters_diff", "hist_gap", "state_gap"}


def test_metrics_name_their_cells_and_moves():
    """Every cell a per-layer metric lists reports the end-to-end metric it
    moves, and every cell reports setup_s and one more."""
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert e2e[m["name"]] <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
    for cell in cells:
        reported = {n for n, wl in e2e.items() if cell in wl}
        assert "setup_s" in reported and len(reported) >= 2
    assert json.dumps(BENCH)  # plain JSON
