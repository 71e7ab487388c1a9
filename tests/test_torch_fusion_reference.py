"""The port's multi-view registration against the benchmark's plain
reference (``slcbench/reference/fusion.py``) on the CPU at test size: 4
seeded views at 96x128 of the sweep's scene (``slcbench/posed.py``), grid
step 8, 2 rounds of 3 point-to-plane steps, slc_tpu's normals and
central-difference ones; the bfloat16 reference parts from it; the
absolute trajectory error falls at the cell's 8 rounds of 5 steps on
exact maps; a central-difference normal leaves the point's own depth out;
holes (0 and the not-finite z of a decode's 0 / 0) are holes on both
sides. And the registration's spans and counters: their counts under a
profiler, nothing recorded and no read-back added without one."""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import slc_tpu_torch.fusion_frontend as front
from slc_tpu_torch import fusion, metrics

from slcbench import posed, scenes
from slcbench.reference import fusion as ref

torch.set_num_threads(2)

H, W, VIEWS = 96, 128, 4
SETTINGS = dict(rounds=2, gn_iters=3, grid_step=8, normal_radius=0,
                max_depth_err=2.0, anchor_gauge=True)
#: The same float32 operations in the same order on the same device give
#: the same poses; 1e-5 (a few float32 ulps of a translation of ~10)
#: leaves room for a reduction that torch splits another way.
TOL = 1e-5
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def clean():
    metrics.reset()
    yield
    metrics.reset()


def _views(seed: int, noise: float, h: int = H, w: int = W):
    """(depths (S, H, W) float32, cam_k, rot0, trans0, rot_gt, trans_gt):
    the sweep's scene, shifted and the poses perturbed from the seed, on
    a camera as wide as the reference rig's (focal 600 px at 1280
    columns), with N(0, noise) added to every depth."""
    cal = scenes.synthetic_calibration(h, w, 96, 640,
                                       cam_f=600.0 * w / 1280)
    ren = scenes.Renderer(cal, {"cam_h": h, "cam_w": w}, "cpu",
                          torch.Generator().manual_seed(seed), 0.0)
    rng = np.random.default_rng(seed)
    shift = rng.uniform(-3.0, 3.0, size=2)
    rot_gt, trans_gt = posed.orbit(VIEWS)
    rot0, trans0 = posed.perturb(rng, rot_gt, trans_gt, 0.01, 0.15)
    gen = torch.Generator().manual_seed(seed)
    maps = []
    for v in range(VIEWS):
        z = ren.geometry(posed.surface(rot_gt[v], trans_gt[v], shift))[0]
        z = z + noise * torch.randn(z.shape, generator=gen,
                                    dtype=torch.float64)
        maps.append(torch.where((z >= 10) & (z <= 100), z, 0.0).float())
    return (torch.stack(maps), cal["cam_k"], rot0.astype(np.float32),
            trans0.astype(np.float32), rot_gt, trans_gt)


def _port(depths, cam_k, rot0, trans0, **kw):
    return front.register_scans(depths, cam_k, rot0, trans0, device="cpu",
                                **{**SETTINGS, **kw})


@pytest.mark.parametrize("radius", [0, 2])
@pytest.mark.parametrize("noise", [0.0, 0.02], ids=["exact", "noisy"])
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_register_scans_equals_the_reference(seed, noise, radius):
    depths, cam_k, rot0, trans0, _, _ = _views(seed, noise)
    rot, trans = _port(depths, cam_k, rot0, trans0, normal_radius=radius)
    r_ref, t_ref = ref.register(depths, cam_k, rot0, trans0,
                                {**SETTINGS, "normal_radius": radius})
    assert r_ref.dtype == torch.float32
    assert ref.pose_gap(rot, trans, r_ref, t_ref) <= TOL
    assert ref.pose_gap(rot, trans, rot0, trans0) > 100 * TOL


def test_the_bfloat16_reference_parts_from_it():
    depths, cam_k, rot0, trans0, _, _ = _views(3, 0.0)
    rot, trans = _port(depths, cam_k, rot0, trans0)
    r16, t16 = ref.register(depths, cam_k, rot0, trans0, SETTINGS,
                            torch.bfloat16)
    assert r16.dtype == t16.dtype == torch.bfloat16
    assert ref.pose_gap(rot, trans, r16, t16) > 100 * TOL


@pytest.mark.parametrize("radius", [0, 1])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_the_trajectory_error_falls(seed, radius):
    """Exact maps at 192x256 (96x128 holds too few grid points for the
    sweep's scene to fix 6 degrees of freedom a view), the cell's 8
    rounds of 5 steps, slc_tpu's normals and central differences: from
    ~0.2 to under a quarter of it."""
    depths, cam_k, rot0, trans0, rot_gt, trans_gt = _views(seed, 0.0, 192,
                                                           256)
    rot, trans = _port(depths, cam_k, rot0, trans0, rounds=8, gn_iters=5,
                       normal_radius=radius)
    ate0 = ref.ate_rmse(rot0, trans0, rot_gt, trans_gt)
    ate = ref.ate_rmse(rot, trans, rot_gt, trans_gt)
    assert ate < 0.25 * ate0, (ate0, ate)
    # fusion.ate_rmse's form, in float64.
    got = float(fusion.ate_rmse(rot, trans,
                                torch.tensor(rot_gt, dtype=torch.float32),
                                torch.tensor(trans_gt, dtype=torch.float32)))
    assert got == pytest.approx(ate, abs=1e-5)


@pytest.mark.parametrize("radius", [1, 3])
def test_a_central_normal_leaves_the_points_own_depth_out(radius):
    """Moving every grid pixel's own depth (as a decode's error does)
    turns slc_tpu's normals, which share it, and leaves the central
    differences' unchanged: a point's error no longer tilts its own
    normal, which on decoded maps biased every residual (PERF.md, the
    sweep cell)."""
    depths, cam_k, _, _, _, _ = _views(3, 0.02)
    cam_k = torch.as_tensor(cam_k, dtype=torch.float32)
    moved = depths.clone()
    ys, xs = front._grid(H, W, 8, "cpu")
    at = moved[:, ys[:, None], xs[None, :]]
    moved[:, ys[:, None], xs[None, :]] = torch.where(at > 0, at + 0.05, at)
    for r in (0, radius):
        _, n, ok = front.grid_points_normals(depths, cam_k, 8, r)
        _, n_moved, ok_moved = front.grid_points_normals(moved, cam_k, 8, r)
        both = ok & ok_moved
        assert int(both.sum()) > 0.9 * int(ok.sum()) > 0
        turned = (n - n_moved)[both].abs().amax()
        assert (turned > 1e-3) if r == 0 else (turned == 0)


def test_holes_are_holes_on_both_sides():
    """A block of 0 in one view and a scatter of NaN in another (a decode
    writes 0 for a hole, and NaN where its triangulation divides 0 by 0):
    the poses stay finite, equal the reference's, and equal those of the
    same maps with every NaN made 0."""
    depths, cam_k, rot0, trans0, _, _ = _views(5, 0.02)
    holed = depths.clone()
    holed[1, 20:60, 30:90] = 0.0
    gen = torch.Generator().manual_seed(1)
    nan = torch.rand((H, W), generator=gen) < 0.05
    holed[2][nan] = math.nan
    holed[3, :, :8] = math.nan      # whole grid columns
    rot, trans = _port(holed, cam_k, rot0, trans0)
    assert bool(torch.isfinite(rot).all() and torch.isfinite(trans).all())
    r_ref, t_ref = ref.register(holed, cam_k, rot0, trans0, SETTINGS)
    assert ref.pose_gap(rot, trans, r_ref, t_ref) <= TOL
    zeroed = torch.nan_to_num(holed, nan=0.0)
    rz, tz = _port(zeroed, cam_k, rot0, trans0)
    assert torch.equal(rot, rz) and torch.equal(trans, tz)
    # The holes change the problem: not the poses of the whole maps.
    rw, tw = _port(depths, cam_k, rot0, trans0)
    assert ref.pose_gap(rot, trans, rw, tw) > 0


def test_grid_points_of_a_nan_depth_are_holes():
    """Grid pixel (6, 6) of a 16x16 plane at step 4 (rows and columns 2,
    6, 10, 14) is NaN: its point is the camera centre and it is no
    landmark, in the port and the reference alike; no neighbour of
    another grid pixel is touched."""
    depth = torch.full((1, 16, 16), 50.0)
    depth[0, 6, 6] = math.nan
    cam_k = torch.tensor([[20.0, 0.0, 7.5], [0.0, 20.0, 7.5],
                          [0.0, 0.0, 1.0]])
    for pts, nrm, ok in (front.grid_points_normals(depth, cam_k, 4),
                         ref.grid_points_normals(depth, cam_k, 4)):
        assert bool(torch.isfinite(pts).all() and torch.isfinite(nrm).all())
        assert pts[0, 5].tolist() == [0.0, 0.0, 0.0]
        assert nrm[0, 5].tolist() == [0.0, 0.0, 0.0]
        assert ok[0].tolist() == [i != 5 for i in range(16)]


# --- spans and counters -------------------------------------------------

class _ReadBacks(TorchDispatchMode):
    """Counts the values read to the host (``int``, ``item``, ``bool`` of
    a tensor): on the card each is a synchronisation."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_spans_and_counters_of_a_registration():
    depths, cam_k, rot0, trans0, _, _ = _views(3, 0.0)
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            _port(depths, cam_k, rot0, trans0)
    spans, c = metrics.span_totals(), metrics.counters()
    rounds, steps = SETTINGS["rounds"], SETTINGS["gn_iters"]
    # The steps ran plain on the CPU: none counts as the kernels'.
    assert c == {"fusion.calls": 2, "fusion.gn_steps": 2 * rounds * steps,
                 "fusion.p2l_kernel": 0}
    assert {k: v["calls"] for k, v in spans.items()} == {
        "fusion.register": 2, "fusion.associate": 2 * (rounds + 1),
        "fusion.p2l_gn": 2 * rounds, "fusion.anchor_gauge": 2}
    reg = spans["fusion.register"]
    inner = sum(spans[k]["total_ns"] for k in ("fusion.associate",
                                               "fusion.p2l_gn",
                                               "fusion.anchor_gauge"))
    assert reg["total_ns"] >= inner
    assert reg["self_ns"] == reg["total_ns"] - inner
    # Without the gauge: no anchor span, one association a round.
    metrics.reset()
    with torch.profiler.profile(activities=CPU):
        _port(depths, cam_k, rot0, trans0, anchor_gauge=False)
    spans = metrics.span_totals()
    assert "fusion.anchor_gauge" not in spans
    assert spans["fusion.associate"]["calls"] == rounds


def test_without_a_profiler_nothing_is_recorded_nor_read_back(monkeypatch):
    depths, cam_k, rot0, trans0, _, _ = _views(3, 0.0)

    def refuse(*a, **k):
        raise AssertionError("a synchronisation")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    reads = {}
    for profiled in (False, True):
        metrics.reset()
        ctx = (torch.profiler.profile(activities=CPU) if profiled
               else torch.autograd.profiler.record_function("unprofiled"))
        with ctx, _ReadBacks() as mode:
            got = _port(depths, cam_k, rot0, trans0)
        reads[profiled] = mode.n
        if not profiled:
            assert metrics.span_totals() == {} and metrics.counters() == {}
            want = got
    # One read-back a call, the solves' summed failure codes, either way.
    assert reads == {False: 1, True: 1}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
