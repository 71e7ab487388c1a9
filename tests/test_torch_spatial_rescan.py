"""The spatial re-scan configuration on the CPU at the port's 96x160 test
rig: ``pipeline.decode_spatial_frame`` against the benchmark's plain
reference (``slcbench/reference/spatial.py``), unanchored and anchored on
a moved scene's previous map; the reference's fringe orders against a
converged least-squares solve; the ``rescan`` driver's runs, sound and
with the decode broken underneath; the bfloat16 control; the K-cycle's
level visits that ``mgsmooth_roofline`` counts; and the unwrap's spans
and counters under a profiler and without one, and no CUDA graph on the
CPU."""

import dataclasses
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

import slc_tpu_torch.pipeline as ppipeline
from slc_tpu_torch import calib as pcalib
from slc_tpu_torch import metrics
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.kernels import mgsmooth
from slc_tpu_torch.ops import unwrap_spatial as U
from slc_tpu_torch.ops.triangulate import triangulate_xyz

from slcbench import harness, scenes
from slcbench.reference import plain, spatial

torch.set_num_threads(2)

SYS = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5,
           phase_steps=4, fov_min=10.0, fov_max=100.0, reco_window=21,
           max_frames=100)
CFG = SystemConfig(**SYS)
T = float(CFG.phase_period)
SPATIAL = dict(period=T, min_modulation=2.0, unwrap_iters=300, tol=3e-4,
               mg=True, filter_depth=True,
               bilateral=dict(radius=1, sigma_color=10.0, sigma_space=25.0))
REAL = "dynaframe_1024x1280_spatial.rescan100"
CELL = "tiny_spatial.rescan"
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def clean():
    metrics.reset()
    yield
    metrics.reset()


@pytest.fixture(scope="module")
def rig():
    cal = scenes.synthetic_calibration(96, 160, 96, 640)
    pc = pcalib.Calibration.from_numpy(cal["cam_k"], cal["pro_k"],
                                       cal["rot"], cal["trans"])
    ren = scenes.renderer({"system": SYS}, cal, "cpu", 11, 1.0)
    return (ren, pcalib.build_tables(pc, 96, 160, device="cpu"),
            plain.build_tables(cal, 96, 160, "cpu"))


SURFACES = {"plane": scenes.plane(52.0, 0.06, -0.04),
            "sphere": scenes.sphere((2.0, -1.0, 60.0), 20.0, 76.0)}


def _phases(ren, surface):
    _, pu = ren.geometry(surface)
    return ren.quantize(torch.stack(
        [scenes.fringe_at(pu, k, 4, T) for k in range(4)]))


def _previous_map(ren, surface, tables_ref):
    """The Gray + phase decode of the scene 0.08 nearer: the map a
    re-scan of the moved scene is anchored on."""
    imgs = ren.gray_phase(scenes.offset(surface, -0.08))
    b = 2 * SYS["gray_bits"]
    return plain.decode_grayphase(imgs[:b], imgs[b:], tables_ref, SYS)[1]


@pytest.mark.parametrize("anchored", [False, True],
                         ids=["unanchored", "anchored"])
@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_decode_equals_the_reference(rig, surface, anchored):
    ren, pt, rt = rig
    imgs = _phases(ren, SURFACES[surface])
    anchor = _previous_map(ren, SURFACES[surface], rt) if anchored else None
    got = ppipeline.decode_spatial_frame(imgs, pt, CFG, T, anchor=anchor)
    z, pu, iters = spatial.decode_spatial(imgs, rt, SYS, SPATIAL, anchor)
    _, info = U.unwrap_spatial(plain.decode_phase(imgs, T, torch.float32), T,
                               quality=plain.modulation(imgs, torch.float32),
                               anchor=anchor, return_info=True)
    assert iters == info["cg_iters"] >= 1
    decoded = (pu != 0) | (got.proj_u != 0)
    assert decoded.float().mean() > 0.9
    assert torch.equal(got.proj_u[decoded], pu[decoded])
    inner = (slice(1, -1), slice(1, -1))
    assert float((got.z[inner] - z[inner]).abs().max()) <= 8e-3
    if anchored:
        # Anchored, the map keeps the true fringe order.
        _, pu_true = ren.geometry(SURFACES[surface])
        d = (pu.double() - pu_true)[pu != 0]
        assert abs(float(d.median())) < 0.1


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_orders_match_a_converged_solve(rig, surface):
    """The stopping rule (relative residual 3e-4) against plain
    Jacobi-preconditioned CG in float64 to 1e-6 from the same anchor:
    the congruence snap leaves the fringe order of at least 99% of the
    decoded pixels as the converged solve has it."""
    ren, _, rt = rig
    imgs = _phases(ren, SURFACES[surface])
    anchor = _previous_map(ren, SURFACES[surface], rt)
    psi = plain.decode_phase(imgs, T, torch.float32)
    q = plain.modulation(imgs, torch.float32)
    got, iters = spatial.unwrap(psi, T, q, anchor, 300, 3e-4)
    want, n = spatial.unwrap(psi.double(), T, q.double(), anchor, 20000,
                             1e-6, mg=False)
    assert n > iters and n < 20000
    decoded = q > SPATIAL["min_modulation"]
    same = torch.round((got.double() - want) / T) == 0
    assert float(same[decoded].double().mean()) >= 0.99


# --- the rescan driver at test size -----------------------------------

def _bench(tmp) -> str:
    """The benchmark copied under ``tmp`` with a tiny re-scan cell: the
    configuration on the 96x160 rig, 2 sequences of 6 frames."""
    src = os.path.join(os.path.dirname(harness.HERE), "slcbench")
    d = os.path.join(str(tmp), "slcbench")
    shutil.copytree(src, d, ignore=shutil.ignore_patterns("__pycache__",
                                                          "tests"))
    c = harness.load_json(os.path.join(d, "configs",
                                       "dynaframe_1024x1280_spatial.json"))
    c.update(name="tiny_spatial")
    c["system"].update(cam_h=96, cam_w=160, pro_h=96, pro_w=640,
                       gray_bits=5)
    tr = harness.load_json(os.path.join(d, "traffic", "rescan100.json"))
    tr.update(frames=6, warmup_frames=2)
    b = harness.load_json(os.path.join(os.path.dirname(src),
                                       "BENCHMARK.json"))
    b["workloads"].append({"name": CELL, "config": "tiny_spatial",
                           "traffic": "tiny_rescan", "chips": 1,
                           "why": "test size"})
    for m in b["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + [CELL]
    shutil.copy(os.path.join(d, "checks", REAL + ".json"),
                os.path.join(d, "checks", CELL + ".json"))
    for path, obj in (("configs/tiny_spatial.json", c),
                      ("traffic/tiny_rescan.json", tr),
                      ("BENCHMARK.json", b)):
        with open(os.path.join(d, path), "w") as f:
            json.dump(obj, f)
    return d


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _bench(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def run(monkeypatch):
    """One run of the tiny cell on the CPU, as run.py runs a cell. This
    test process has loaded JAX before (the suite compares the port with
    it); the run's own check still ends it for any module of the JAX
    stack that the run loads."""
    before = set(harness.forbidden_modules())
    real = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules", lambda modules=None: [
        m for m in real(modules) if m not in before])

    def run(d, seed=4242, trace=False, seconds=0.4):
        b = harness.load_json(os.path.join(d, "BENCHMARK.json"))
        return harness.run_cell(b, d, CELL, seed, seconds, trace, "cpu",
                                time.perf_counter())
    return run


def test_a_rescan_run_is_correct(tiny, run):
    # The window counts the maps started before it closes. A tiny map
    # takes ~50 ms alone, but ~350 ms on a host that runs the rest of
    # the suite beside it: a window of 3 s holds the 4 maps on any host
    # that takes under 0.75 s a map.
    out = run(tiny, seed=2**31 + 977, seconds=3.0)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 4
    c = out["checks"]
    assert c["decode_off_share"]["value"] == 0.0
    assert c["rescan_off_share"]["value"] == 0.0
    assert c["rescan_global_slip"]["value"] < 0.05


def _stale(real):
    """The decode hands back its anchor: P unchanged, z from it."""
    def decode(images, tables, cfg, period, anchor=None, **k):
        real(images, tables, cfg, period, anchor=anchor, **k)
        x, y, z = triangulate_xyz(anchor, tables, cfg.fov_min, cfg.fov_max)
        return ppipeline.FrameResult(x=x, y=y, z=z, proj_u=anchor)
    return decode


def _banded(real):
    """z off by 0.05 in the first eighth of the rows."""
    def decode(*a, **k):
        res = real(*a, **k)
        band = torch.zeros_like(res.z, dtype=torch.bool)
        band[: res.z.shape[0] // 8] = True
        return dataclasses.replace(
            res, z=torch.where(band & (res.z > 0), res.z + 0.05, res.z))
    return decode


def _slipped(real):
    """A whole period added to the first spatial map of each sequence
    (the one anchored on frame 0's map); the later maps follow it."""
    firsts = []
    first = ppipeline.decode_first_frame

    def decode_first(*a, **k):
        res = first(*a, **k)
        firsts.append(res.proj_u)
        return res

    def decode(images, tables, cfg, period, anchor=None, **k):
        res = real(images, tables, cfg, period, anchor=anchor, **k)
        if any(anchor is p for p in firsts):
            pu = torch.where(res.proj_u != 0, res.proj_u + period,
                             res.proj_u)
            x, y, z = triangulate_xyz(pu, tables, cfg.fov_min, cfg.fov_max,
                                      pu != 0)
            return ppipeline.FrameResult(x=x, y=y, z=z, proj_u=pu)
        return res
    decode.first = decode_first
    return decode


@pytest.mark.parametrize("fault,number", [
    (_stale, "rescan_off_share"), (_banded, "rescan_off_share"),
    (_slipped, "rescan_global_slip")], ids=["stale", "band", "slip"])
def test_a_broken_decode_is_not_correct(tiny, run, monkeypatch, fault,
                                        number):
    broken = fault(ppipeline.decode_spatial_frame)
    monkeypatch.setattr(ppipeline, "decode_spatial_frame", broken)
    if hasattr(broken, "first"):
        monkeypatch.setattr(ppipeline, "decode_first_frame", broken.first)
    out = run(tiny)
    assert out["correct"] is False, out["checks"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


def test_the_bfloat16_control_parts_from_the_reference(rig, tiny):
    ren, _, rt = rig
    imgs = _phases(ren, SURFACES["plane"])
    anchor = _previous_map(ren, SURFACES["plane"], rt)
    z32, pu32, _ = spatial.decode_spatial(imgs, rt, SYS, SPATIAL, anchor)
    z16, pu16, _ = spatial.decode_spatial(imgs, rt, SYS, SPATIAL, anchor,
                                          torch.bfloat16)
    assert pu16.dtype == z16.dtype == torch.bfloat16
    assert float((pu16.float() - pu32).abs().median()) > 0.02
    b = harness.load_json(os.path.join(tiny, "BENCHMARK.json"))
    cell = harness.make_cell(b, tiny, CELL, 99, "cpu",
                             harness.Spans(False, lambda: None))
    drv = harness.make_driver(cell, tiny)
    drv.prepare()
    checked = harness.check_numbers(drv.control(torch.bfloat16),
                                    cell.checks)
    assert not harness.is_correct(checked)
    c = checked["rescan_off_share"]
    assert c["value"] > c["limit"], checked


def test_the_driver_refuses_settings_the_port_does_not_run(tiny):
    c = harness.load_json(os.path.join(tiny, "configs", "tiny_spatial.json"))
    mod = harness.load_module(tiny, "drivers", "rescan")
    cal = scenes.calibration(c)
    mod.Program(c, cal, "cpu")
    c["spatial"]["tol"] = 1e-4
    with pytest.raises(ValueError, match="tol"):
        mod.Program(c, cal, "cpu")


def test_mgsmooth_roofline_counts_the_k_cycles_level_visits(monkeypatch):
    """The reader's levels and visits a preconditioner call are the
    port's: one K-cycle at 1030x600 (coarse levels 515x300 and 258x150)
    sends mg_down and mg_up to the levels at least 256 px on both sides,
    as often as the reader counts."""
    reader = harness.load_module(harness.HERE, "metrics",
                                 "mgsmooth_roofline")
    assert reader.kernel_levels(1024, 1280) == [
        (1024, 1280, 1), (512, 640, 2), (256, 320, 4)]
    h, w = 1030, 600
    calls = []
    for name in ("mg_down", "mg_up"):
        real = getattr(mgsmooth, name)

        def counted(*a, real=real, name=name, **k):
            calls.append((name, tuple(a[1 if name == "mg_up" else 0].shape)))
            return real(*a, **k)
        monkeypatch.setattr(mgsmooth, name, counted)
    rng = np.random.default_rng(3)
    wy, wx = U.edge_weights(torch.from_numpy(
        rng.uniform(0.1, 1.0, (h, w)).astype(np.float32)))
    levels = U.build_mg_levels(wy, wx, h, w)
    U.vcycle(torch.from_numpy(rng.standard_normal((h, w)).astype(
        np.float32)), levels)
    want = [(lh, lw, v) for lh, lw, v in reader.kernel_levels(h, w)]
    assert want == [(1030, 600, 1), (515, 300, 2)]
    for kind in ("mg_down", "mg_up"):
        got = {}
        for k, shape in calls:
            if k == kind:
                got[shape] = got.get(shape, 0) + 1
        assert got == {(lh, lw): v for lh, lw, v in want}, kind


# --- spans and counters -----------------------------------------------

def test_spans_and_counters_of_the_spatial_decode(rig):
    ren, pt, rt = rig
    surf = SURFACES["sphere"]
    imgs = _phases(ren, surf)
    anchor = _previous_map(ren, surf, rt)
    ppipeline.decode_spatial_frame(imgs, pt, CFG, T, anchor=anchor)
    assert metrics.span_totals() == {} and metrics.counters() == {}
    psi = plain.decode_phase(imgs, T, torch.float32)
    q = plain.modulation(imgs, torch.float32)
    _, info = U.unwrap_spatial(psi, T, quality=q, anchor=anchor,
                               return_info=True)
    assert metrics.counters() == {}
    metrics.reset()
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            ppipeline.decode_spatial_frame(imgs, pt, CFG, T, anchor=anchor)
    s, c = metrics.span_totals(), metrics.counters()
    assert s["decode.spatial"]["calls"] == 2
    assert s["unwrap.levels"]["calls"] == 2
    # Two coarsest visits a preconditioner call at 96x160 (levels 96x160,
    # 48x80, 24x40), 1 + cg_iters calls a decode; none by the kernel.
    assert c == {"unwrap.calls": 2, "unwrap.cg_iters": 2 * info["cg_iters"],
                 "unwrap.coarse_visits": 2 * 2 * (info["cg_iters"] + 1),
                 "unwrap.coarse_kernel": 0}
    # One read-back a CG iteration and one for the test that ends it.
    assert s["unwrap.wait"]["calls"] == 2 * (info["cg_iters"] + 1)
    assert s["decode.spatial"]["total_ns"] >= s["unwrap.wait"]["total_ns"]


def test_the_unwrap_on_the_cpu_captures_no_graph(rig, monkeypatch):
    """A CPU tensor runs the CG launch by launch: no graph is made or
    cached, and under a profiler the graph counters stay absent."""
    ren, _, rt = rig
    surf = SURFACES["plane"]
    imgs = _phases(ren, surf)
    psi = plain.decode_phase(imgs, T, torch.float32)
    q = plain.modulation(imgs, torch.float32)

    def refuse(*a, **k):
        raise AssertionError("a CUDA graph for a CPU tensor")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(U, "_CGGraphs", refuse)
    cached = U._cg_graphs.cache_info().currsize
    with torch.profiler.profile(activities=CPU):
        got, info = U.unwrap_spatial(psi, T, quality=q,
                                     anchor=_previous_map(ren, surf, rt),
                                     return_info=True)
    assert U._cg_graphs.cache_info().currsize == cached
    c = metrics.counters()
    assert c == {"unwrap.calls": 1, "unwrap.cg_iters": info["cg_iters"],
                 "unwrap.coarse_visits": 2 * (info["cg_iters"] + 1),
                 "unwrap.coarse_kernel": 0}
    assert "unwrap.graph_replays" not in c
    assert "unwrap.graph_captures" not in c
    assert info["cg_iters"] >= 1 and bool(torch.isfinite(got).all())


NEW = ("spatial.decode_ms", "spatial.host_ms", "unwrap.wait_ms",
       "unwrap.cg_iters")


def test_a_traced_run_reports_the_cells_metrics(tiny, run, monkeypatch):
    """On the CPU the two rooflines find no kernel; the four others read
    the window. A program without the spatial spans and counters (the
    one before them) leaves its three out, and raises nothing."""
    out = run(tiny, trace=True)
    assert out["correct"] is True
    got = out["metrics"]
    assert set(NEW) <= set(got)
    assert got["unwrap.cg_iters"]["value"] >= 1
    assert 0 < got["unwrap.wait_ms"]["value"] < got["spatial.host_ms"][
        "value"] <= got["spatial.decode_ms"]["value"] * 1.5
    totals, counters = metrics.span_totals, metrics.counters
    monkeypatch.setattr(metrics, "span_totals", lambda: {
        k: v for k, v in totals().items()
        if k not in ("decode.spatial", "unwrap.wait", "unwrap.levels")})
    monkeypatch.setattr(metrics, "counters", lambda: {
        k: v for k, v in counters().items() if not k.startswith("unwrap.")})
    out = run(tiny, trace=True)
    assert out["correct"] is True
    assert set(out["metrics"]) & set(NEW) == {"spatial.decode_ms"}
