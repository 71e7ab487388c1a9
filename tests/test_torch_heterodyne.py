"""slc_tpu_torch's heterodyne decode (the plain path the kernel is held
to) against slc_tpu: ``heterodyne_unwrap`` on the scenes of
tests/test_decode.py:155-175, and ``decode_heterodyne_frame`` against
the XLA path and against the Pallas kernel in interpret mode. Beat-order
flips are pinned by count (conftest.assert_heterodyne_parity: at most 8,
each exactly +-1 fine order, no 2x2 block); z and x 4e-3, y 1e-3 off
them, the bars of tests/test_pallas.py:103-120. The frame decode also
runs at 3 frequencies x 5 steps, which the CUDA kernel's generic instance
takes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import assert_heterodyne_parity

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import HeterodyneConfig as JHet
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.ops.unwrap import heterodyne_unwrap as j_unwrap
from slc_tpu.pallas.heterodyne import heterodyne_decode_pallas
from slc_tpu.pipeline import decode_heterodyne_frame as j_decode

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.kernels.heterodyne import heterodyne_decode
from slc_tpu_torch.ops.unwrap import heterodyne_unwrap
from slc_tpu_torch.pipeline import decode_heterodyne_frame

torch.set_num_threads(2)

PRO_W = 640


def test_heterodyne_unwrap_exact_matches_jax():
    periods = (PRO_W / 64, PRO_W / 59, PRO_W / 55)
    x = np.linspace(0.5, PRO_W - 1.5, 3001)
    wrapped = np.stack([np.mod(x, p) for p in periods]
                       ).astype(np.float32)[:, None, :]
    got = heterodyne_unwrap(torch.from_numpy(wrapped), periods,
                            float(PRO_W)).numpy()
    want = np.asarray(j_unwrap(jnp.asarray(wrapped), periods, float(PRO_W)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got[0], x, atol=2e-3)


def test_heterodyne_unwrap_noisy_matches_jax():
    rng = np.random.default_rng(1234)
    periods = (10.0, PRO_W / 59, PRO_W / 55)
    x = rng.uniform(1.0, PRO_W - 1.0, size=(64, 128))
    noise = rng.normal(0.0, 0.02, size=(3,) + x.shape)
    wrapped = np.stack([np.mod(x + noise[i], p)
                        for i, p in enumerate(periods)]).astype(np.float32)
    got = heterodyne_unwrap(torch.from_numpy(wrapped), periods,
                            float(PRO_W)).numpy()
    want = np.asarray(j_unwrap(jnp.asarray(wrapped), periods, float(PRO_W)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got - x).max() < 0.1


def _scene(h, w, steps=4):
    kw = dict(cam_h=h, cam_w=w, pro_h=96, pro_w=PRO_W, gray_bits=5)
    jcfg, cfg = JConfig(**kw), SystemConfig(**kw)
    cal = dict(cam_h=h, cam_w=w, pro_h=96, pro_w=PRO_W)
    jc = jcalib.synthetic_calibration(**cal)
    tc = tcalib.synthetic_calibration(**cal)
    het = JHet(phase_steps=steps)
    imgs, _, _ = jsynth.render_fringe_stack(
        jc, jcfg, jsynth.sphere_surface(), het.periods(PRO_W),
        het.phase_steps, noise_sigma=1.0)
    return (jcfg, cfg, jcalib.build_tables(jc, h, w),
            tcalib.build_tables(tc, h, w, device="cpu"), imgs)


def _assert_parity(got, x, y, z, pu):
    m = assert_heterodyne_parity(got.proj_u.numpy(), pu, PRO_W / 64,
                                 max_divergent=8)
    np.testing.assert_allclose(got.z.numpy()[m], np.asarray(z)[m], atol=4e-3)
    np.testing.assert_allclose(got.x.numpy()[m], np.asarray(x)[m], atol=4e-3)
    np.testing.assert_allclose(got.y.numpy()[m], np.asarray(y)[m], atol=1e-3)


@pytest.mark.parametrize(
    "shape,steps", [((96, 160), 4), ((90, 150), 4), ((96, 160), 5),
                    ((90, 150), 5)],
    ids=["shape0", "shape1", "shape0-steps5", "shape1-steps5"])
@pytest.mark.parametrize("min_mod", [2.0, None])
def test_decode_heterodyne_frame_matches_jax(shape, steps, min_mod):
    jcfg, cfg, jt, tt, imgs = _scene(*shape, steps)
    got = decode_heterodyne_frame(torch.from_numpy(imgs), tt, cfg,
                                  HeterodyneConfig(phase_steps=steps),
                                  min_modulation=min_mod)

    xla = j_decode(jnp.asarray(imgs), jt, jcfg, JHet(phase_steps=steps),
                   min_modulation=min_mod, use_pallas=False)
    _assert_parity(got, xla.x, xla.y, xla.z, xla.proj_u)

    scalars = jnp.stack([jt.a, jt.b, jt.fx, jt.fy, jt.cx, jt.cy,
                         jnp.float32(0.0), jnp.float32(0.0)]).reshape(1, 8)
    x, y, z, pu = heterodyne_decode_pallas(
        jnp.asarray(imgs), jt.c, jt.d, scalars,
        periods=JHet().periods(PRO_W), extent=float(PRO_W), n_steps=steps,
        min_modulation=min_mod, fov_min=jcfg.fov_min, fov_max=jcfg.fov_max,
        block_h=32, interpret=True)
    _assert_parity(got, x, y, z, pu)


def test_heterodyne_masks_dark_pixels_as_holes():
    _, cfg, _, tt, imgs = _scene(96, 160)
    got = decode_heterodyne_frame(torch.zeros(imgs.shape, dtype=torch.uint8),
                                  tt, cfg, HeterodyneConfig())
    assert (got.proj_u == 0).all() and (got.z == 0).all()
    assert torch.isfinite(got.x).all()


def test_heterodyne_short_cascade_raises():
    """Periods whose beat cascade cannot span the projector width."""
    _, cfg, _, tt, _ = _scene(96, 160)
    het = HeterodyneConfig(fringe_counts=(64, 56, 50))
    imgs = torch.zeros((het.num_images, 96, 160), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cascade"):
        decode_heterodyne_frame(imgs, tt, cfg, het)
    periods = (10.0, 12.0, 14.0)                  # cascade reaches 210
    with pytest.raises(ValueError, match="cascade"):
        heterodyne_unwrap(torch.zeros((3, 4, 4)), periods, float(PRO_W))
    with pytest.raises(ValueError, match="cascade"):
        j_unwrap(jnp.zeros((3, 4, 4)), periods, float(PRO_W))


def test_heterodyne_too_few_steps_raises():
    _, cfg, _, tt, _ = _scene(96, 160)
    het = HeterodyneConfig(phase_steps=2)
    imgs = torch.zeros((het.num_images, 96, 160), dtype=torch.uint8)
    with pytest.raises(ValueError, match="n_steps"):
        decode_heterodyne_frame(imgs, tt, cfg, het)


def test_heterodyne_cuda_tensor_without_card_raises():
    """A tensor on any device but the CPU goes to the kernel: there is no
    fallback to the plain path."""
    _, cfg, _, tt, imgs = _scene(96, 160)
    meta = torch.empty(imgs.shape, dtype=torch.uint8, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        heterodyne_decode(meta, tt, cfg, HeterodyneConfig())
