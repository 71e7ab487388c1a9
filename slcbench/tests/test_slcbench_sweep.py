"""The multi-view sweep cell at test size on the CPU: a small configuration
(8 views at 192x320 on the port's test rig, its focal lengths scaled so
that the camera keeps the reference rig's ~94 degrees) through
``slcbench_small``'s copy of the benchmark, run by the ``sweep`` driver;
a registration that keeps its initial poses fails the check; the traced
run's per-layer metrics; ``register_scans_roofline``'s byte count; the
order control (the reference against itself summed in another order)
and ``calibrate.py --order-seeds``. On the card: both controls, the
reference in bfloat16 and with TF32 matrix products, fail the cell's
check at its own size, and the order control reads under the pose
gap's limit (run with ``python -m pytest slcbench/tests -q --noconftest
-m cuda``)."""

import io
import json
import math
import os
from contextlib import redirect_stdout

import pytest
import torch

import slc_tpu_torch.fusion_frontend as front
import slcbench_small as small
from slcbench import calibrate, harness

REAL = "dynaframe_1024x1280_fuse16.sweep16"
VIEWS = 8
CELL = "tiny_fuse.sweep"
NEW = ("fuse.views_ms", "fuse.register_ms", "fusion.host_ms",
       "fusion.gn_steps", "register_scans_roofline")


def make(tmp) -> str:
    """``slcbench_small``'s benchmark copy with the small sweep cell added
    as files, its check the real cell's but for the ATE's limit.

    The cell's 8 rounds of 5 steps; a grid step of 8 (24 x 40 points a
    view) and normals over 2 px, the cell's ~1.4 scene units of stencil
    at this camera's coarser pixels. Registrations at this size leave
    0.37-0.70 of the initial ATE (seeds 5, 77, 1234, 2**31 + 4099): 960
    points a view hold the poses more loosely than the cell's 5,120, so
    the limit here is 0.9, which a registration that keeps its initial
    poses (1.0) still fails."""
    d = small.make(tmp)
    c = harness.load_json(os.path.join(d, "configs",
                                       "dynaframe_1024x1280_fuse16.json"))
    c.update(name="tiny_fuse")
    c["system"].update(small.TINY, cam_h=192, cam_w=320)
    c["calibration"].update(cam_f=600.0 * 320 / 1280,
                            pro_f=400.0 * 640 / 1280)
    c["fusion"].update(views=VIEWS, grid_step=8, normal_radius=2)
    tr = harness.load_json(os.path.join(d, "traffic", "sweep16.json"))
    b = harness.load_json(os.path.join(d, "BENCHMARK.json"))
    b["workloads"].append({"name": CELL, "config": "tiny_fuse",
                           "traffic": "tiny_sweep", "chips": 1,
                           "why": "test size"})
    for m in b["end_to_end"] + b["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + [CELL]
    ck = harness.load_json(os.path.join(d, "checks", REAL + ".json"))
    ck["limits"]["fuse_ate_share"]["limit"] = 0.9
    for path, obj in (("configs/tiny_fuse.json", c),
                      ("checks/" + CELL + ".json", ck),
                      ("traffic/tiny_sweep.json", tr),
                      ("BENCHMARK.json", b)):
        with open(os.path.join(d, path), "w") as f:
            json.dump(obj, f)
    return d


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make(tmp_path_factory.mktemp("bench"))


def test_a_sweep_run_is_correct(tiny):
    out = small.run(tiny, CELL, seed=2**31 + 4099, seconds=1.0)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= VIEWS and out["attempted"] % VIEWS == 0
    c = out["checks"]
    assert c["decode_off_share"]["value"] == 0.0
    # The same float32 operations in the same order on the same device.
    assert c["fuse_pose_gap"]["value"] == 0.0
    assert c["fuse_ate_share"]["value"] < 0.9
    assert set(out["metrics"]) == {"maps_per_s", "setup_s"}


def test_a_registration_that_keeps_its_initial_poses_fails(tiny,
                                                           monkeypatch):
    """The program's poses are the initial ones: the ATE share reads 1.0
    and the gap to the reference's registration is far over its
    limit."""
    def keep(depths, cam_k, rot0, trans0, **kw):
        dev = kw["device"]
        return (torch.as_tensor(rot0, device=dev),
                torch.as_tensor(trans0, device=dev))
    monkeypatch.setattr(front, "register_scans", keep)
    out = small.run(tiny, CELL, seed=5, seconds=0.3)
    assert out["correct"] is False
    c = out["checks"]
    assert c["fuse_ate_share"]["value"] == pytest.approx(1.0, abs=1e-6)
    assert c["fuse_pose_gap"]["value"] > 100 * c["fuse_pose_gap"]["limit"]


def test_a_traced_run_reports_the_cells_metrics(tiny):
    """On the CPU the roofline finds no device time; the four others read
    the window, 40 point-to-plane steps a registration at 8 rounds x 5."""
    out = small.run(tiny, CELL, trace=True, seconds=0.5)
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    assert set(NEW) - set(got) == {"register_scans_roofline"}
    assert got["fusion.gn_steps"]["value"] == 40.0
    assert 0 < got["fusion.host_ms"]["value"] \
        <= got["fuse.register_ms"]["value"]
    assert got["fuse.views_ms"]["value"] > 0


def test_register_scans_roofline_counts_its_bytes():
    """16 views at 1024x1280, grid step 16: G = 64 x 80 = 5,120 points a
    view, L = 81,920 landmarks, S L = 1,310,720 pairs; 8 + 1 associations
    and 8 x 5 = 40 steps each move 16 S L + 24 L = 22,937,600 B."""
    reader = harness.load_module(harness.HERE, "metrics",
                                 "register_scans_roofline")
    cfg = harness.load_json(os.path.join(
        harness.HERE, "configs", "dynaframe_1024x1280_fuse16.json"))
    assert reader.call_bytes(cfg) == 49 * 22_937_600 == 1_123_942_400
    cfg["fusion"]["anchor_gauge"] = False
    assert reader.call_bytes(cfg) == 48 * 22_937_600


class _Trace:
    saw_device = True
    idle_by_span = {"fuse.register": 0.05}


def test_register_scans_roofline_reads_busy_time():
    """Two calls of 1,123,942,400 B at 3.35 TB/s need 0.671 ms; the spans
    held 0.3 s of which 0.05 s idle: 0.268% of the busy 0.25 s."""
    reader = harness.load_module(harness.HERE, "metrics",
                                 "register_scans_roofline")
    cfg = harness.load_json(os.path.join(
        harness.HERE, "configs", "dynaframe_1024x1280_fuse16.json"))
    run = harness.Run(config=cfg, latencies_s=[],
                      spans={"fuse.register": [0.1, 0.2]}, trace=_Trace(),
                      hbm_bytes_per_s=3.35e12)
    want = 100 * 2 * 1_123_942_400 / 3.35e12 / 0.25
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    run.hbm_bytes_per_s = None
    assert reader.read(run) is None


def _driver(root, d, name, seed, device):
    """Cell ``name`` of the BENCHMARK.json in ``root``, its files in ``d``,
    and its driver."""
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    c = harness.make_cell(bench, d, name, seed, device,
                          harness.Spans(False, lambda: None))
    return c, harness.make_driver(c, d)


def test_the_order_control_reads_the_sum_order_spread(tiny):
    """Permuted landmarks give a finite gap of a float32 rounding's size
    on each sweep's first job; the identity permutation gives the
    reference's own registration to the bit."""
    torch.set_num_threads(2)
    c, drv = _driver(tiny, tiny, CELL, 2**31 + 4099, "cpu")
    drv.prepare()
    got = drv.order_control()
    assert len(got["gaps"]) == len(drv.sweeps) == 2
    assert math.isfinite(got["fuse_pose_gap"])
    assert got["fuse_pose_gap"] == max(got["gaps"])
    assert got["fuse_pose_gap"] < c.checks["limits"]["fuse_pose_gap"][
        "limit"]
    same = drv.order_control(order=lambda n: torch.arange(n))
    assert same == {"fuse_pose_gap": 0.0, "gaps": [0.0, 0.0]}


def test_calibrate_prints_one_line_per_order_seed(tiny, monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(calibrate, "ROOT", tiny)
    monkeypatch.setattr(calibrate, "BENCH_DIR", tiny)
    out = io.StringIO()
    with redirect_stdout(out):
        assert calibrate.main(["--workload", CELL, "--order-seeds", "5,6",
                               "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert [(x["kind"], x["seed"]) for x in lines] == [("order", 5),
                                                      ("order", 6)]
    for x in lines:
        assert math.isfinite(x["fuse_pose_gap"]) and len(x["gaps"]) == 2


def test_calibrate_refuses_order_seeds_where_the_driver_has_none(
        tiny, monkeypatch):
    monkeypatch.setattr(calibrate, "ROOT", tiny)
    monkeypatch.setattr(calibrate, "BENCH_DIR", tiny)
    with pytest.raises(SystemExit):
        calibrate.main(["--workload", "tiny_gray.scan", "--order-seeds",
                        "5", "--device", "cpu"])


@pytest.mark.cuda
def test_the_order_control_reads_under_the_limit_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c, drv = _driver(os.path.dirname(harness.HERE), harness.HERE, REAL,
                     2**31 + 12, "cuda")
    drv.prepare()
    got = drv.order_control()["fuse_pose_gap"]
    assert 0.0 <= got <= c.checks["limits"]["fuse_pose_gap"]["limit"]


@pytest.mark.cuda
def test_both_controls_fail_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c, drv = _driver(os.path.dirname(harness.HERE), harness.HERE, REAL,
                     2**31 + 11, "cuda")
    drv.prepare()
    for dt, tf32 in ((torch.bfloat16, False), (torch.float32, True)):
        checked = harness.check_numbers(drv.control(dt, tf32), c.checks)
        assert not harness.is_correct(checked), (dt, tf32, checked)
