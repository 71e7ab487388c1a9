"""A copy of the benchmark at test size for the CPU tests: the same
harness, drivers, metrics and reference, with configurations cut to the
port's 96x160 test rig and mixes of a few short sequences and scans."""

import json
import os
import shutil
import time

import torch

from slcbench import harness

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

TINY = {"cam_h": 96, "cam_w": 160, "pro_h": 96, "pro_w": 640,
        "gray_bits": 5}
#: A heterodyne frame 0 (the decode the benchmark keeps for a
#: configuration that states one), on the tiny rig.
HETERODYNE = {"decode": "heterodyne",
              "heterodyne": {"fringe_counts": [64, 59, 55], "phase_steps": 4,
                             "min_modulation": 2.0}}
CELLS = {"tiny_gray.track": ("tiny_gray", "tiny_track"),
         "tiny_het.track": ("tiny_het", "tiny_track"),
         "tiny_gray.scan": ("tiny_gray", "tiny_scan"),
         "tiny_het.scan": ("tiny_het", "tiny_scan")}


def bench() -> dict:
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def make(tmp) -> str:
    """A benchmark folder under ``tmp`` with the tiny cells added as
    files; returns it. Its BENCHMARK.json keeps the real metrics."""
    d = os.path.join(str(tmp), "slcbench")
    shutil.copytree(BENCH_DIR, d, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for name, extra in (("tiny_gray", {}), ("tiny_het", HETERODYNE)):
        c = harness.load_json(os.path.join(d, "configs",
                                           "dynaframe_1024x1280.json"))
        c.update(name=name, **extra)
        c["system"].update(TINY)
        _dump(os.path.join(d, "configs", name + ".json"), c)
    tr = harness.load_json(os.path.join(d, "traffic", "track100.json"))
    tr.update(sequences=2, frames=8, checked_frames=2, warmup_frames=2)
    _dump(os.path.join(d, "traffic", "tiny_track.json"), tr)
    sc = harness.load_json(os.path.join(d, "traffic", "scan.json"))
    sc.update(scans=4, checked=3)
    _dump(os.path.join(d, "traffic", "tiny_scan.json"), sc)
    b = bench()
    for cell, (cfg, traffic) in CELLS.items():
        src = ("dynaframe_1024x1280.track100" if "track" in cell
               else "dynaframe_1024x1280.scan")
        shutil.copy(os.path.join(d, "checks", src + ".json"),
                    os.path.join(d, "checks", cell + ".json"))
        b["workloads"].append({"name": cell, "config": cfg,
                               "traffic": traffic, "chips": 1,
                               "why": "test size"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [
                t for w in m["workloads"] for t in TWIN.get(w, ())]
    b["per_layer"].append({
        "name": "heterodyne_roofline", "unit": "%", "better": "higher",
        "source": "device_trace",
        "layer": "kernels (slc_tpu_torch/kernels/csrc)",
        "moves": "maps_per_s", "workloads": ["tiny_het.scan"]})
    _dump(os.path.join(d, "BENCHMARK.json"), b)
    return d


#: Each real cell's tiny twins: a Gray and a heterodyne frame 0 (the
#: latter also reports the heterodyne kernel's roofline).
TWIN = {"dynaframe_1024x1280.track100": ("tiny_gray.track",
                                         "tiny_het.track"),
        "dynaframe_1024x1280.scan": ("tiny_gray.scan", "tiny_het.scan")}


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run(d, cell, seed=123, seconds=0.5, trace=False) -> dict:
    """One run of a tiny cell on the CPU, as run.py runs a cell."""
    torch.set_num_threads(2)
    b = harness.load_json(os.path.join(d, "BENCHMARK.json"))
    return harness.run_cell(b, d, cell, seed, seconds, trace, "cpu",
                            time.perf_counter())
