"""A run's result line at test size on the CPU, with tracing off and on:
the keys every result line has, the cell's metrics with their units, every
compared number beside its limit under the last key. And ``run.py``
exits non-zero, printing no result, on a machine without a CUDA card."""

import json
import os
import subprocess
import sys

import pytest
import torch

import slcbench_small as small
from slcbench import harness


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return small.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(small.CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny, cell, trace):
    out = small.run(tiny, cell, seed=2**31 + 17, seconds=0.4, trace=trace)
    json.loads(json.dumps(out))
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    bench = harness.load_json(os.path.join(tiny, "BENCHMARK.json"))
    want = {m["name"]: m["unit"]
            for m in harness.cell_metrics(bench, cell, trace)}
    got = {k: v["unit"] for k, v in out["metrics"].items()}
    # On the CPU the device metrics find nothing to read.
    device = {"device.idle_pct", "device.idle_pct.track",
              "kernel_ms_per_map", "dynamic_step_roofline",
              "grayphase_roofline", "heterodyne_roofline"}
    assert got == {k: u for k, u in want.items() if k not in device}
    for v in out["metrics"].values():
        assert isinstance(v["value"], float)
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(out["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    checks = harness.load_json(os.path.join(tiny, "checks", cell + ".json"))
    assert list(out["checks"]) == list(checks["limits"])
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    root = os.path.dirname(harness.HERE)
    out = subprocess.run(
        [sys.executable, "slcbench/run.py", "--workload",
         "dynaframe_1024x1280.scan", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=root)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_device_end_to_end_reads_kernels_over_maps():
    """``kernel_ms_per_map`` is the kernels' device time over the maps
    (copies left out); ``track.maps_per_s`` the maps over the window's
    wall time; neither reads without its trace or window."""
    from slcbench import trace as tracemod
    tr = tracemod.Trace(window_s=1.0, busy_s=0.5,
                        kernels={"a": (3, 0.002), "b": (1, 0.001)},
                        device_ops={"a": 0.002, "b": 0.001,
                                    "Memcpy HtoD": 0.4},
                        idle_by_span={})
    run = harness.Run(config={}, latencies_s=[1e-3] * 3, spans={},
                      trace=tr, hbm_bytes_per_s=None, wall_s=0.5)
    kernels = harness.load_module(harness.HERE, "metrics",
                                  "kernel_ms_per_map")
    rate = harness.load_module(harness.HERE, "metrics", "track.maps_per_s")
    assert kernels.read(run) == pytest.approx(1.0)
    assert rate.read(run) == pytest.approx(6.0)
    bare = harness.Run(config={}, latencies_s=[1e-3] * 3, spans={},
                       trace=None, hbm_bytes_per_s=None)
    assert kernels.read(bare) is None and rate.read(bare) is None
