"""slc_tpu_torch.ops.unwrap_spatial and kernels.mgsmooth (the plain
versions the kernels are held to) against slc_tpu on the CPU: the
helpers and the multigrid hierarchy to 1e-6, one K-cycle to 1e-5 of its
largest value, the level ops against the XLA ops and the Pallas level
kernels in interpret mode to 2e-6 (tests/test_pallas.py:404-437), and
whole unwraps on the
scenes of tests/test_unwrap_spatial.py: no fringe-order difference, the
CG iteration count within one, the same residue and suspect counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.ops import unwrap_spatial as J
from slc_tpu.pallas.mgsmooth import mg_down_pallas, mg_up_pallas
from slc_tpu.pipeline import decode_spatial_frame as j_decode

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.kernels import mgsmooth
from slc_tpu_torch.ops import unwrap_spatial as T
from slc_tpu_torch.pipeline import decode_spatial_frame

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _weights(rng, h, w):
    q = rng.uniform(0.1, 1.0, (h, w)).astype(np.float32)
    return q, J.edge_weights(jnp.asarray(q)), T.edge_weights(_t(q))


@pytest.mark.parametrize("shape", [(37, 50), (40, 48)])
def test_helpers_match_jax(shape):
    rng = np.random.default_rng(7)
    h, w = shape
    t = 32.0
    psi = rng.uniform(0, t, (h, w)).astype(np.float32)
    for a, b in zip(J.wrapped_gradients(jnp.asarray(psi), t),
                    T.wrapped_gradients(_t(psi), t)):
        _close(b, a, 1e-6)
    d = np.array([0.0, 19.9, 20.0, -20.0, 39.0, -39.0], np.float32)
    _close(T.wrap_to_half(_t(d), 40.0), J.wrap_to_half(jnp.asarray(d), 40.0),
           1e-6)
    _, (jwy, jwx), (twy, twx) = _weights(rng, h, w)
    _close(twy, jwy, 1e-6)
    _close(twx, jwx, 1e-6)
    dy, dx = J.wrapped_gradients(jnp.asarray(psi), t)
    _close(T._rhs(_t(dy), _t(dx), twy, twx), J._rhs(dy, dx, jwy, jwx), 1e-6)
    _close(T._diag(twy, twx), J._diag(jwy, jwx), 1e-6)
    p = rng.normal(0, 1, (h, w)).astype(np.float32)
    _close(T._matvec(_t(p), twy, twx), J._matvec(jnp.asarray(p), jwy, jwx),
           1e-6)
    _close(T.restrict2(_t(p)), J.restrict2(jnp.asarray(p)), 1e-6)
    e = rng.normal(0, 1, (-(-h // 2), -(-w // 2))).astype(np.float32)
    _close(T.prolong2(_t(e), h, w), J.prolong2(jnp.asarray(e), h, w), 1e-6)
    for a, b in zip(J.coarsen_weights(jwy, jwx, h, w),
                    T.coarsen_weights(twy, twx, h, w)):
        _close(b, a, 1e-6)
    _close(T.residues(_t(psi), t), J.residues(jnp.asarray(psi), t), 0)
    q = rng.uniform(0.1, 1.0, (h, w)).astype(np.float32)
    pp = psi + t * rng.integers(0, 3, (h, w)).astype(np.float32)
    np.testing.assert_array_equal(
        T.suspect_edges(_t(pp), _t(psi), t, _t(q)).numpy(),
        np.asarray(J.suspect_edges(jnp.asarray(pp), jnp.asarray(psi), t,
                                   jnp.asarray(q))))
    ref = (psi + rng.uniform(-15, 15, psi.shape)).astype(np.float32)
    _close(T.unwrap_to_reference(_t(psi), t, _t(ref)),
           J.unwrap_to_reference(jnp.asarray(psi), t, jnp.asarray(ref)), 0)


def test_build_mg_levels_matches_jax():
    rng = np.random.default_rng(3)
    h, w = 75, 130
    _, (jwy, jwx), (twy, twx) = _weights(rng, h, w)
    jl = J.build_mg_levels(jwy, jwx, h, w)
    tl = T.build_mg_levels(twy, twx, h, w)
    assert [lv[3] for lv in tl] == [lv[3] for lv in jl]
    for a, b in zip(jl, tl):
        for x, y in zip(a[:3], b[:3]):
            _close(y, x, 1e-6)


@pytest.mark.parametrize("shape,coarsest", [((40, 48), 16),
                                            ((256, 264), 32)])
def test_vcycle_matches_jax(shape, coarsest):
    """One K-cycle application, to 1e-5 of its largest value (the cycle
    amplifies O(1) data to O(100)); at 256x264 the top level goes
    through kernels.mgsmooth (its plain version on the CPU)."""
    rng = np.random.default_rng(11)
    h, w = shape
    _, (jwy, jwx), (twy, twx) = _weights(rng, h, w)
    r = rng.normal(0, 1, (h, w)).astype(np.float32)
    want = J.vcycle(jnp.asarray(r),
                    J.build_mg_levels(jwy, jwx, h, w, coarsest=coarsest))
    got = T.vcycle(_t(r), T.build_mg_levels(twy, twx, h, w,
                                            coarsest=coarsest))
    want = np.asarray(want)
    _close(got, want, 1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(96, 200), (97, 201)])
def test_mg_level_ops_match_xla_and_pallas(shape):
    """The plain level ops against slc_tpu's XLA vcycle ops and its Pallas
    level kernels in interpret mode (tests/test_pallas.py:404-437), on an
    even and an odd level shape."""
    rng = np.random.default_rng(1234)
    h, w = shape
    om = jnp.float32(0.9)
    q = rng.uniform(0.1, 1.0, (h, w)).astype(np.float32)
    wy, wx = J.edge_weights(jnp.asarray(q))
    dinv = 1.0 / J._diag(wy, wx)
    r = rng.normal(0, 1, (h, w)).astype(np.float32)
    e0 = rng.normal(0, 1, (h, w)).astype(np.float32)
    args = [_t(a) for a in (r, wy, wx, dinv)]

    e_ref = om * dinv * jnp.asarray(r)
    e_ref = e_ref + om * dinv * (r - J._matvec(e_ref, wy, wx))
    res_ref = r - J._matvec(e_ref, wy, wx)
    e_k, res_k = mg_down_pallas(jnp.asarray(r), wy, wx, dinv, block_h=32,
                                interpret=True)
    e_t, res_t = mgsmooth.mg_down(*args)
    for want in ((e_ref, res_ref), (e_k, res_k)):
        _close(e_t, want[0], 2e-6)
        _close(res_t, want[1], 2e-6)

    up_ref = jnp.asarray(e0)
    for _ in range(2):
        up_ref = up_ref + om * dinv * (r - J._matvec(up_ref, wy, wx))
    up_k = mg_up_pallas(jnp.asarray(e0), jnp.asarray(r), wy, wx, dinv,
                        block_h=32, interpret=True)
    up_t = mgsmooth.mg_up(_t(e0), *args)
    _close(up_t, up_ref, 2e-6)
    _close(up_t, up_k, 2e-6)


def test_mg_cuda_tensor_without_card_raises():
    meta = torch.empty((8, 8), device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        mgsmooth.mg_down(meta, meta[1:], meta[:, 1:], meta)


def _ramp(rng):
    t, h, w = 32.0, 96, 128
    x = np.linspace(0, 6 * t, w)[None, :] + np.linspace(0, t, h)[:, None]
    return t, x, np.mod(x, t), None, x, 300


def _noise_band(rng):
    t, h, w = 32.0, 96, 128
    x = np.linspace(0, 5 * t, w)[None, :] + 0.3 * np.arange(h)[:, None]
    psi = np.mod(x, t)
    q = np.ones((h, w))
    psi[40:48] = rng.uniform(0, t, size=(8, w))
    q[40:48] = 1e-3
    return t, x, psi, q, x, 800


def _box_step(rng):
    """tests/test_unwrap_spatial.py:111-159: a raised box, its 2-px edge
    ring at zero quality, noise 0.05, a perturbed anchor."""
    t, h, w = 32.0, 96, 128
    x = np.linspace(0, 5 * t, w)[None, :] + 0.4 * np.arange(h)[:, None]
    box = np.zeros((h, w), bool)
    box[h // 3: 2 * h // 3, w // 3: 2 * w // 3] = True
    x = x + 3.7 * t * box
    psi = np.mod(x + rng.normal(0, 0.05, (h, w)), t)
    inner = np.zeros_like(box)
    inner[h // 3 + 2: 2 * h // 3 - 2, w // 3 + 2: 2 * w // 3 - 2] = True
    outer = np.zeros_like(box)
    outer[h // 3 - 2: 2 * h // 3 + 2, w // 3 - 2: 2 * w // 3 + 2] = True
    q = np.ones((h, w))
    q[outer & ~inner] = 0.0
    anchor = x + rng.uniform(-t / 3, t / 3, x.shape)
    return t, x, psi, q, anchor, 800


@pytest.mark.parametrize("scene", [_ramp, _noise_band, _box_step],
                         ids=["ramp", "noise_band", "box_step"])
def test_unwrap_spatial_matches_jax(scene):
    t, x, psi, q, anchor, iters = scene(np.random.default_rng(1234))
    jq = None if q is None else jnp.asarray(q, jnp.float32)
    tq = None if q is None else _t(q)
    want, jinfo = J.unwrap_spatial(jnp.asarray(psi, jnp.float32), t,
                                   quality=jq, max_iters=iters,
                                   anchor=jnp.asarray(anchor, jnp.float32),
                                   return_info=True)
    got, info = T.unwrap_spatial(_t(psi), t, quality=tq, max_iters=iters,
                                 anchor=_t(anchor), return_info=True)
    want, got = np.asarray(want), got.numpy()
    assert (np.abs(got - want) > t / 2).sum() == 0
    _close(got, want, 1e-3)
    assert abs(info["cg_iters"] - int(jinfo["cg_iters"])) <= 1
    assert int(info["residue_count"]) == int(jinfo["residue_count"])
    assert int(info["suspect_count"]) == int(jinfo["suspect_count"])
    assert (int(info["anchor_disagreement_count"])
            == int(jinfo["anchor_disagreement_count"]))
    assert float(info["rel_residual"]) <= 3e-4


def test_unwrap_spatial_without_mg_matches_jax():
    """The Jacobi-preconditioned path (mg=False), self-anchored."""
    t, _, psi, _, _, _ = _ramp(None)
    want = J.unwrap_spatial(jnp.asarray(psi, jnp.float32), t, mg=False)
    got = T.unwrap_spatial(_t(psi), t, mg=False)
    assert (np.abs(got.numpy() - np.asarray(want)) > t / 2).sum() == 0


def test_decode_spatial_frame_matches_jax():
    """tests/test_unwrap_spatial.py:79-104 on both packages: compared on
    the interior, where the bilateral border semantics agree."""
    kw = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
    jcfg, cfg = JConfig(**kw), SystemConfig(**kw)
    cal = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    jc = jcalib.synthetic_calibration(**cal)
    tc = tcalib.synthetic_calibration(**cal)
    period = 20.0
    imgs, z_gt, pu_gt = jsynth.render_fringe_stack(
        jc, jcfg, jsynth.plane_surface(50.0, 0.05, 0.0), [period], 4,
        noise_sigma=1.0)
    want = j_decode(jnp.asarray(imgs), jcalib.build_tables(jc, 96, 160),
                    jcfg, period, anchor=jnp.asarray(pu_gt, jnp.float32),
                    unwrap_iters=500)
    got = decode_spatial_frame(torch.from_numpy(imgs),
                               tcalib.build_tables(tc, 96, 160, device="cpu"), cfg, period,
                               anchor=_t(pu_gt), unwrap_iters=500)
    inner = (slice(1, -1), slice(1, -1))
    _close(got.proj_u.numpy(), want.proj_u, 1e-3)
    for k in ("z", "x", "y"):
        _close(getattr(got, k).numpy()[inner],
               np.asarray(getattr(want, k))[inner], 4e-3)
    z = got.z.numpy()
    valid = z > 0
    assert valid.mean() > 0.95
    assert np.sqrt(np.mean((z[valid] - z_gt[valid]) ** 2)) < 0.05
