"""Multi-scan fusion: slc_tpu_torch.se3, .fusion and .fusion_frontend on
the CPU against slc_tpu's on the same inputs (numpy, from a seed).

Bars: se3 1e-6; one gn_step / gn_step_p2l 1e-5 on rotations and 1e-4
relative on translations; fuse_scans 1e-4 on rotations and 1e-3 on
translations (tests/test_fusion.py's distributed bars) and test_fusion.py's
ATE bars; associate_projective at most 0.1% of the mask flipped, obs,
landmarks and normals within 1e-4 where both masks hold; register_scans
ATE < 0.05 and < 0.25 x the initial ATE, poses within 2e-3 of slc_tpu's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slc_tpu import fusion as jfusion
from slc_tpu import fusion_frontend as jfront
from slc_tpu import se3 as jse3
from slc_tpu.calib import synthetic_calibration
from slc_tpu.synth import render_depth_from_pose

from slc_tpu_torch import fusion, fusion_frontend as front, se3

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _n(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


# ------------------------------------------------------------------ se3

def _se3_inputs():
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.5, (7, 3)).astype(np.float32)
    w[0] = 0.0                                   # the small-angle limit
    w[1] = [1e-8, -2e-8, 5e-9]
    return w, rng.normal(0, 1, (7, 6)).astype(np.float32), \
        rng.normal(0, 10, (7, 5, 3)).astype(np.float32)


_SE3_CASES = {
    "hat": lambda m, w, xi, p: m.hat(w),
    "exp_so3": lambda m, w, xi, p: m.exp_so3(w),
    "exp_se3": lambda m, w, xi, p: m.exp_se3(xi),
    "apply": lambda m, w, xi, p: m.apply(m.exp_so3(w), xi[:, None, :3], p),
    "compose": lambda m, w, xi, p: m.compose(m.exp_so3(w), xi[:, :3],
                                             m.exp_so3(xi[:, 3:]),
                                             xi[:, 3:]),
    "invert": lambda m, w, xi, p: m.invert(m.exp_so3(w), xi[:, :3]),
}


@pytest.mark.parametrize("fn", sorted(_SE3_CASES))
def test_se3_matches_slc_tpu(fn):
    w, xi, p = _se3_inputs()
    got = _SE3_CASES[fn](se3, _t(w), _t(xi), _t(p))
    want = _SE3_CASES[fn](jse3, jnp.asarray(w), jnp.asarray(xi),
                          jnp.asarray(p))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, e in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_n(g), np.asarray(e), rtol=0, atol=1e-6
                                   * max(1.0, float(np.abs(e).max())))


# --------------------------------------------------------- bundle adjustment

def _problem(seed=1234, **kw):
    """The same synthetic problem in both packages (one seed each)."""
    want = jfusion.synthetic_problem(np.random.default_rng(seed), **kw)
    got = fusion.synthetic_problem(np.random.default_rng(seed), device="cpu",
                                   **kw)
    return got, want


def test_synthetic_problem_matches_slc_tpu():
    got, want = _problem(noise=0.01)
    for g, e in zip(got, want):
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_allclose(_n(g), np.asarray(e), atol=1e-6)


def test_fusion_exact_recovery():
    (obs, mask, rot_gt, trans_gt), _ = _problem(noise=0.0)
    rot, trans, lm = fusion.fuse_scans(obs, mask, iters=15)
    assert float(fusion.ate_rmse(rot, trans, rot_gt, trans_gt)) < 1e-3


def test_fusion_noise_ate():
    (obs, mask, rot_gt, trans_gt), _ = _problem(noise=0.01)
    rot, trans, lm = fusion.fuse_scans(obs, mask, iters=15)
    assert float(fusion.ate_rmse(rot, trans, rot_gt, trans_gt)) < 0.05


def test_fusion_residual_decreases():
    (obs, mask, _, _), _ = _problem(noise=0.005)

    def cost(r, t, x):
        res = fusion.residuals(r, t, x, obs, mask)
        return float(torch.sum(res * res))
    s = obs.shape[0]
    rot0 = torch.eye(3).expand(s, 3, 3)
    t0 = torch.zeros((s, 3))
    lm0 = (torch.einsum("sij,slj->sli", rot0, obs) * mask[..., None]).sum(0) \
        / mask.sum(0)[:, None].clamp_min(1.0)
    c0 = cost(rot0, t0, lm0)
    rot, trans, lm = fusion.fuse_scans(obs, mask, iters=15)
    assert cost(rot, trans, lm) < 1e-3 * c0


def _init(obs, mask):
    s = obs.shape[0]
    rot = np.broadcast_to(np.eye(3, dtype=np.float32), (s, 3, 3)).copy()
    trans = np.zeros((s, 3), np.float32)
    lm = ((obs * mask[..., None]).sum(0)
          / np.maximum(mask.sum(0)[:, None], 1.0)).astype(np.float32)
    return rot, trans, lm


def _assert_poses(got, want, rot_atol, trans_rtol):
    (gr, gt), (er, et) = [tuple(_n(a) for a in x[:2]) for x in (got, want)]
    np.testing.assert_allclose(gr, er, rtol=0, atol=rot_atol)
    np.testing.assert_allclose(gt, et, rtol=0,
                               atol=trans_rtol * np.abs(et).max())


def test_gn_step_matches_slc_tpu():
    """One step from the state after slc_tpu's first step, at the bars.
    The first step from the identity is ill-conditioned at float32:
    there slc_tpu's own step lies 2.3e-5 (rotations) from the float64
    step, so two float32 orders of summation cannot agree to 1e-5; the
    port's step must lie no farther from the float64 step than
    slc_tpu's."""
    _, (obs, mask, _, _) = _problem(s=8, l=96, noise=0.01)
    obs, mask = np.asarray(obs), np.asarray(mask)
    first = _init(obs, mask)
    mid = tuple(map(np.asarray, jfusion.gn_step(
        *map(jnp.asarray, (*first, obs, mask)))))
    got = fusion.gn_step(*map(_t, (*mid, obs, mask)))
    want = jfusion.gn_step(*map(jnp.asarray, (*mid, obs, mask)))
    _assert_poses(got, want, 1e-5, 1e-4)
    np.testing.assert_allclose(_n(got[2]), np.asarray(want[2]), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want[2])).max())

    exact = fusion.gn_step(*(torch.from_numpy(np.asarray(a, np.float64))
                             for a in (*first, obs, mask)))
    got = fusion.gn_step(*map(_t, (*first, obs, mask)))
    want = jfusion.gn_step(*map(jnp.asarray, (*first, obs, mask)))
    for g, w, e in zip(got, want, exact):
        e = e.numpy()
        assert np.abs(_n(g) - e).max() <= np.abs(np.asarray(w) - e).max()


def test_fuse_scans_matches_slc_tpu():
    got_p, want_p = _problem(s=8, l=96, noise=0.01)
    got = fusion.fuse_scans(*got_p[:2], iters=10)
    want = jfusion.fuse_scans(*want_p[:2], iters=10)
    _assert_poses(got, want, 1e-4, 1e-3)
    assert float(fusion.ate_rmse(*got[:2], *got_p[2:])) < 0.05


def test_reduce_fn_identity_is_no_reduce_fn():
    """gn_step with an identity ``reduce_fn`` (the one-shard reduction) is
    gn_step without one, bit for bit; it reduces the Schur terms and the
    landmark solves' info code (slc_tpu/fusion.py:131-144)."""
    _, (obs, mask, _, _) = _problem(s=8, l=96, noise=0.01)
    args = tuple(map(_t, (*_init(np.asarray(obs), np.asarray(mask)), obs,
                          mask)))
    seen = []

    def ident(v):
        seen.append(tuple(v.shape))
        return v
    for got, want in zip(fusion.gn_step(*args, reduce_fn=ident),
                         fusion.gn_step(*args)):
        assert torch.equal(got, want)
    assert seen == [(8, 6, 6), (8, 6, 8, 6), (8, 6), ()]


def test_check_info_raises_on_a_failed_factorization():
    fusion.check_info(torch.zeros((), dtype=torch.int64), "ok")
    with pytest.raises(RuntimeError, match="singular"):
        fusion.check_info(torch.tensor(3), "gn_step")


def test_full_f32_pins_and_restores_matmul_precision():
    """Inside a fusion call TF32 is off whatever the caller set; the
    caller's settings come back afterwards, also after an exception; and
    a caller with TF32 on gets the same poses."""
    (obs, mask, _, _), _ = _problem(noise=0.01)
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32)
    seen = fusion.highest_precision(lambda: (
        torch.get_float32_matmul_precision(),
        torch.backends.cuda.matmul.allow_tf32))
    try:
        want = fusion.fuse_scans(obs, mask, iters=5)
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        assert seen() == ("highest", False)
        assert (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32) == ("high", True)
        with pytest.raises(ValueError):
            fusion.highest_precision(lambda: int("x"))()
        assert torch.get_float32_matmul_precision() == "high"
        got = fusion.fuse_scans(obs, mask, iters=5)
        for g, e in zip(got, want):
            assert torch.equal(g, e)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]


# ------------------------------------------------------- depth-map frontend

H, W = 120, 160


def _depth_scans(s, pose, perturb, seed=1234):
    """Depth maps ray-cast from ``pose(i)`` (tests/test_fusion.py's
    wide-FOV rig) and initial poses perturbed by ``perturb(rng, i)``."""
    calib = synthetic_calibration(cam_h=H, cam_w=W, cam_f=130.0)
    rot_gt, trans_gt = zip(*(pose(i) for i in range(s)))
    rot_gt, trans_gt = np.stack(rot_gt), np.stack(trans_gt)
    depths = np.stack([render_depth_from_pose(calib, H, W, rot_gt[i],
                                              trans_gt[i])
                       for i in range(s)]).astype(np.float32)
    rng = np.random.default_rng(seed)
    rot0, trans0 = rot_gt.copy(), trans_gt.copy()
    for i in range(1, s):
        rot0[i], trans0[i] = perturb(rng, rot0[i], trans0[i])
    cam_k = np.asarray(calib.cam_k, np.float32)
    f32 = (lambda a: np.asarray(a, np.float32))
    return depths, cam_k, f32(rot0), f32(trans0), f32(rot_gt), f32(trans_gt)


def _exp(w):
    return np.asarray(jse3.exp_so3(jnp.asarray(w, jnp.float32)), np.float64)


@pytest.fixture(scope="module")
def four_scans():
    """tests/test_fusion.py:64-113's setting: 4 scans, translations up to
    6 units, init perturbed by 0.01 rad and 0.15 units."""
    def pose(i):
        return _exp([0.0, 0.06 * i, 0.0]), np.array([2.0 * i, 0.1 * i,
                                                     -0.5 * i])

    def perturb(rng, r, t):
        return _exp(rng.normal(0, 0.01, 3)) @ r, t + rng.normal(0, 0.15, 3)
    return _depth_scans(4, pose, perturb)


def test_associate_projective_matches_slc_tpu(four_scans):
    depths, cam_k, rot0, trans0, _, _ = four_scans
    got = front.associate_projective(_t(depths), _t(cam_k), _t(rot0),
                                     _t(trans0), 6, 2.0)
    want = jfront.associate_projective(*map(jnp.asarray, (depths, cam_k,
                                                          rot0, trans0)),
                                       6, 2.0)
    obs, mask, lm, nrm = map(_n, got)
    wobs, wmask, wlm, wnrm = map(np.asarray, want)
    assert mask.dtype == np.float32 and wmask.sum() > 1000
    flips = int((mask != wmask).sum())
    assert flips <= 1e-3 * mask.size, flips
    both = (mask > 0) & (wmask > 0)
    np.testing.assert_allclose(obs[both], wobs[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(lm, wlm, rtol=0, atol=1e-4)
    np.testing.assert_allclose(nrm, wnrm, rtol=0, atol=1e-4)


@pytest.mark.parametrize("step", [1, 6, 7])
def test_backproject_grid_matches_slc_tpu(four_scans, step):
    depth, cam_k = four_scans[0][2].copy(), four_scans[1]
    depth[:20, :30] = 0.0
    pts, ok = front.backproject_grid(_t(depth), _t(cam_k), step)
    want_pts, want_ok = jfront.backproject_grid(jnp.asarray(depth),
                                                jnp.asarray(cam_k), step)
    assert pts.shape == ((H // step) * (W // step), 3)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(pts.numpy(), np.asarray(want_pts), rtol=1e-6,
                               atol=1e-6)


def test_gn_step_p2l_matches_slc_tpu(four_scans):
    """One point-to-plane step from slc_tpu's association at the
    perturbed poses."""
    depths, cam_k, rot0, trans0, _, _ = four_scans
    obs, mask, lm, nrm = map(np.asarray, jfront.associate_projective(
        *map(jnp.asarray, (depths, cam_k, rot0, trans0)), 6, 2.0))
    args = (rot0, trans0, lm, nrm, obs, mask)
    got = fusion.gn_step_p2l(*map(_t, args))
    want = jfusion.gn_step_p2l(*map(jnp.asarray, args))
    _assert_poses(got, want, 1e-5, 1e-4)
    assert torch.equal(got[2], _t(lm))
    seen = []

    def ident(v):
        seen.append(tuple(v.shape))
        return v
    for g, w in zip(fusion.gn_step_p2l(*map(_t, args), reduce_fn=ident),
                    got):
        assert torch.equal(g, w)
    assert seen == [(4, 3), (4,), (4, 6, 6), (4, 6)]


def test_grid_points_normals_matches_the_full_cloud(four_scans):
    """The grid sampled from the whole cloud and its normals (slc_tpu's
    order) equals the arithmetic done at the grid pixels only, wrap-around
    of the last row and column included (step 1 reaches them)."""
    from slc_tpu_torch import cloud
    depth, cam_k = _t(four_scans[0][1]), _t(four_scans[1])
    depth[5:9, 20:30] = 0.0
    for step in (1, 6):
        pts, nrm, ok = front.grid_points_normals(depth, cam_k, step)
        c = cloud.depth_to_cloud(depth, cam_k[0, 0], cam_k[1, 1],
                                 cam_k[0, 2], cam_k[1, 2])
        n, valid = cloud.cloud_normals(c, depth > 0)
        ys, xs = front._grid(H, W, step, "cpu")
        sel = (ys[:, None], xs[None, :])
        assert torch.equal(pts, c[sel].reshape(-1, 3))
        assert torch.equal(nrm, n[sel].reshape(-1, 3))
        assert not (ok & ~valid[sel].reshape(-1)).any()
    want = jfront.grid_points_normals(jnp.asarray(depth.numpy()),
                                      jnp.asarray(cam_k.numpy()), 1)
    got = front.grid_points_normals(depth, cam_k, 1)
    np.testing.assert_array_equal(_n(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(_n(got[1]), np.asarray(want[1]), atol=1e-5)


def test_bilinear_marks_out_of_range_projections_invalid():
    """Landmarks behind a camera, at z ~ 1e-7 or far off-image project to
    huge, infinite or NaN pixel coordinates; none of them may wrap into
    the image through the float -> integer cast."""
    depth = torch.full((1, 12, 16), 40.0)
    p_cam = torch.tensor([[0.5, 0.2, 40.0],        # in view
                          [1.0, 1.0, 1e-7],        # z ~ 1e-7, far off
                          [-1.0, 2.0, 1e-7],
                          [0.3, 0.1, -40.0],       # behind the camera
                          [1e6, 1e6, 1.0],         # far off-image
                          [-3e9, 5e9, 1.0],        # past int32
                          [float("inf"), 0.0, 1.0],
                          [float("nan"), 0.0, 1.0]])
    zc = p_cam[:, 2].clamp_min(1e-6)
    u = p_cam[:, 0] / zc * 10.0 + 8.0
    v = p_cam[:, 1] / zc * 10.0 + 6.0
    z, ok = front._bilinear(depth, u[None], v[None])
    assert ok[0].tolist() == [True] + [False] * 7
    assert float(z[0, 0]) == pytest.approx(40.0)
    # slc_tpu agrees on all but the NaN, whose int32 convert gives 0 there
    # (its depth gate drops it later, as every comparison with NaN fails).
    jz, jok = jfront._bilinear(jnp.asarray(depth[0].numpy()),
                               jnp.asarray(u.numpy()), jnp.asarray(v.numpy()))
    assert np.asarray(jok)[:-1].tolist() == ok[0, :-1].tolist()


def test_register_scans_from_depth_maps(four_scans):
    """Projective-association ICP + BA from perturbed poses converges
    back to ground truth, as slc_tpu's does, and lands within 2e-3 of
    slc_tpu's poses."""
    depths, cam_k, rot0, trans0, rot_gt, trans_gt = four_scans
    kw = dict(rounds=8, gn_iters=5, grid_step=6, max_depth_err=2.0)
    rot, trans = front.register_scans(depths, cam_k, rot0, trans0,
                                      device="cpu", **kw)
    jrot, jtrans = jfront.register_scans(*map(jnp.asarray, (
        depths, cam_k, rot0, trans0)), **kw)
    ate0 = float(fusion.ate_rmse(*map(_t, (rot0, trans0, rot_gt, trans_gt))))
    ate = float(fusion.ate_rmse(rot, trans, _t(rot_gt), _t(trans_gt)))
    assert ate < 0.25 * ate0 and ate < 0.05, (ate0, ate)
    np.testing.assert_allclose(_n(rot), np.asarray(jrot), rtol=0, atol=2e-3)
    np.testing.assert_allclose(_n(trans), np.asarray(jtrans), rtol=0,
                               atol=2e-3)


def test_register_scans_times_its_stages(four_scans):
    depths, cam_k, rot0, trans0, _, _ = four_scans
    kw = dict(rounds=2, gn_iters=2, grid_step=8, max_depth_err=2.0,
              device="cpu")
    timings = {}
    got = front.register_scans(depths, cam_k, rot0, trans0,
                               timings=timings, **kw)
    assert sorted(timings) == ["anchor_gauge", "associate", "p2l_gn"]
    assert all(v > 0 for v in timings.values())
    want = front.register_scans(depths, cam_k, rot0, trans0, **kw)
    for g, e in zip(got, want):
        assert torch.equal(g, e)


def test_anchor_gauge_align_removes_common_mode():
    """tests/test_fusion.py:116-166: a coherent common-mode offset of
    every non-anchor scan is removed by the anchor gauge step."""
    center = np.array([0.0, 0.0, 62.0])
    common = np.array([0.12, -0.05, 0.08])

    def pose(i):
        r = _exp([0.01 * (i - 4), 0.05 * (i - 4), 0.0])
        return r, (np.eye(3) - r) @ center

    def perturb(rng, r, t):
        return r, t + common + rng.normal(0, 0.02, 3)
    depths, cam_k, rot0, trans0, rot_gt, trans_gt = _depth_scans(8, pose,
                                                                 perturb)
    kw = dict(rounds=6, gn_iters=5, grid_step=6, max_depth_err=2.0,
              device="cpu")
    ate = {}
    for gauge in (False, True):
        r, t = front.register_scans(depths, cam_k, rot0, trans0,
                                    anchor_gauge=gauge, **kw)
        ate[gauge] = float(fusion.ate_rmse(r, t, _t(rot_gt), _t(trans_gt)))
    assert ate[True] < 0.05, ate
    assert ate[True] < 0.5 * max(ate[False], 1e-9), ate


def test_register_scans_defaults_to_the_card(four_scans):
    depths, cam_k, rot0, trans0, _, _ = four_scans
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        front.register_scans(depths, cam_k, rot0, trans0, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fusion.synthetic_problem(np.random.default_rng(0))
