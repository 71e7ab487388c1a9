"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files, with no edit to a file of the benchmark: in a
temporary copy, a new configuration, a new mix, a new metric's reader and
the new cell's check limits are added beside the others, the copy's
BENCHMARK.json names them, and a run reports the new metric."""

import json
import os

import slcbench_small as small
from slcbench import harness

READER = '''"""Tracker steps a traced window timed (a count)."""


def read(run):
    t = run.spans.get("track.step")
    return float(len(t)) if t else None
'''


def test_new_files_make_a_new_cell(tmp_path):
    d = small.make(tmp_path)
    before = {os.path.relpath(os.path.join(r, f), d): open(
        os.path.join(r, f), "rb").read()
        for r, _, fs in os.walk(d) for f in fs
        if f != "BENCHMARK.json"}
    c = harness.load_json(os.path.join(d, "configs", "tiny_gray.json"))
    c.update(name="tiny_gray_w31")
    c["system"]["reco_window"] = 31
    tr = harness.load_json(os.path.join(d, "traffic", "tiny_track.json"))
    tr.update(sequences=1, frames=6, z0=[50.0, 50.0])
    for path, obj in (("configs/tiny_gray_w31.json", c),
                      ("traffic/one_plane.json", tr)):
        with open(os.path.join(d, path), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(d, "metrics", "track.steps.py"), "w") as f:
        f.write(READER)
    with open(os.path.join(d, "checks", "tiny_gray_w31.one_plane.json"),
              "w") as f:
        f.write(open(os.path.join(d, "checks",
                                  "tiny_gray.track.json")).read())
    b = harness.load_json(os.path.join(d, "BENCHMARK.json"))
    b["workloads"].append({"name": "tiny_gray_w31.one_plane",
                           "config": "tiny_gray_w31",
                           "traffic": "one_plane", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "track.steps", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "tracker (slc_tpu_torch.dynamic)",
                           "moves": "maps_per_s",
                           "workloads": ["tiny_gray_w31.one_plane"]})
    with open(os.path.join(d, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    out = small.run(d, "tiny_gray_w31.one_plane", seconds=0.4, trace=True)
    assert out["correct"] is True
    assert out["metrics"]["track.steps"]["value"] >= 1
    for rel, body in before.items():
        assert open(os.path.join(d, rel), "rb").read() == body, rel
