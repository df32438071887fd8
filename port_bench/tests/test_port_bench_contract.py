"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files: configurations, mixes, stage drivers, limits and
metric readers."""

import importlib
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert all(w["chips"] == 1 for w in bench["workloads"])
    # a full check, with the full 24 cells, fits in its 43200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in bench[key]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES, m
    for e in bench["configs"] + bench["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"], e["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["workloads"] and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells)), m["name"]
    for cell in cells:
        mine = [m for m in bench["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2, cell
        assert any(cell in m["workloads"] for m in bench["per_layer"]), cell


def test_every_name_resolves(bench):
    from port_bench.run import metric_module, resolve

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        for w in bench["workloads"]:
            spec = resolve(bench, w["name"])
            importlib.import_module(f"port_bench.stages.{spec['traffic']['stage']}").Stage
            assert spec["limits"], w["name"]
            for m in spec["end_to_end"] + spec["per_layer"]:
                assert callable(metric_module(m["name"]).read)
        for c in bench["configs"]:
            assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
            with open(os.path.join(ROOT, c["file"])) as f:
                cfg = json.load(f)
            assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
    finally:
        os.chdir(cwd)
