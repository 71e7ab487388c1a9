"""BENCHMARK.json against the limits of its format, and every file the
harness finds by name: each cell's configuration, traffic mix, driver
and check limits, each per-layer metric's reader."""

import json
import math
import os
import re

import pytest

import slcbench_small as small
from slcbench import harness

ROOT = os.path.dirname(harness.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32 and all(map(_line, bench["command"]))
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # 14 runs of each of 24 cells, plus 2, at run_seconds + 60 s each and
    # 180 s of compilation a cell, fit 12 hours less 20 minutes.
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (
        bench["run_seconds"] + 60)
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(bench["paths"][0] + "/")
        body = harness.load_json(os.path.join(ROOT, c["file"]))
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] == []
        assert body["source"] == c["source"]
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_cells_and_their_files(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    d = harness.HERE
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        tr = harness.load_json(harness.find(d, "traffic", w["traffic"],
                                            ".json"))
        harness.find(d, "drivers", tr["driver"], ".py")
        checks = harness.load_json(harness.find(d, "checks", w["name"],
                                                ".json"))
        assert checks["limits"] and all(
            math.isfinite(v["limit"]) for v in checks["limits"].values())


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(bench["per_layer"]) <= 128
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        harness.find(harness.HERE, "metrics", m["name"], ".py")
        layers.add(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    # Every cell reports setup_s, another end-to-end metric and a
    # per-layer one.
    for w in cells:
        got = [m["name"] for m in harness.cell_metrics(bench, w, False)]
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(bench, w, True)


def test_metric_readers_find_nothing_without_a_trace():
    config = harness.load_json(os.path.join(
        harness.HERE, "configs", "dynaframe_1024x1280.json"))
    config.update(small.HETERODYNE)
    run = harness.Run(config=config, latencies_s=[], spans={}, trace=None,
                      hbm_bytes_per_s=3.35e12)
    for f in sorted(os.listdir(os.path.join(harness.HERE, "metrics"))):
        if f.endswith(".py"):
            mod = harness.load_module(harness.HERE, "metrics", f[:-3])
            assert mod.read(run) is None, f
