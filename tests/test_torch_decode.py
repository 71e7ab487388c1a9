"""slc_tpu_torch.pipeline.decode_first_frame (the plain path the kernel
is held to) against slc_tpu's XLA path and against the Pallas kernel in
interpret mode, on rendered Gray+phase stacks. Bars of
tests/test_pallas.py:176-184: P 2e-3; x, y, z 8e-3."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.pallas.grayphase import grayphase_decode_pallas
from slc_tpu.pipeline import decode_first_frame as j_decode

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.ops import gray as tgray
from slc_tpu_torch.pipeline import decode_first_frame

torch.set_num_threads(2)


def _scene(h, w):
    jcfg = JConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640, gray_bits=5)
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640, gray_bits=5)
    jc = jcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    tc = tcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    scene = jsynth.render_static_scene(jc, jcfg, jsynth.sphere_surface(),
                                       noise_sigma=1.0)
    return (jcfg, cfg, jcalib.build_tables(jc, h, w),
            tcalib.build_tables(tc, h, w, device="cpu"), scene)


def _assert_decode(got, want_x, want_y, want_z, want_pu):
    np.testing.assert_allclose(got.proj_u.numpy(), np.asarray(want_pu),
                               atol=2e-3)
    for g, e in ((got.z, want_z), (got.x, want_x), (got.y, want_y)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=8e-3)


@pytest.mark.parametrize("shape", [(96, 160), (90, 150)])
@pytest.mark.parametrize("min_mod", [None, 2.0])
def test_decode_first_frame_matches_jax(shape, min_mod):
    jcfg, cfg, jt, tt, scene = _scene(*shape)
    g = scene.gray_images
    p = scene.phase_images
    got = decode_first_frame(torch.from_numpy(g), torch.from_numpy(p), tt,
                             cfg, min_modulation=min_mod)

    xla = j_decode(jnp.asarray(g), jnp.asarray(p), jt, jcfg,
                   min_modulation=min_mod, use_pallas=False)
    _assert_decode(got, xla.x, xla.y, xla.z, xla.proj_u)

    scalars = jnp.stack([jt.a, jt.b, jt.fx, jt.fy, jt.cx, jt.cy,
                         jnp.float32(0.0), jnp.float32(0.0)]).reshape(1, 8)
    x, y, z, pu = grayphase_decode_pallas(
        jnp.concatenate([jnp.asarray(g), jnp.asarray(p)], axis=0), jt.c,
        jt.d, scalars, gray_bits=jcfg.gray_bits,
        gray_period=float(jcfg.gray_period),
        phase_period=float(jcfg.phase_period), n_steps=jcfg.phase_steps,
        min_modulation=min_mod, fov_min=jcfg.fov_min, fov_max=jcfg.fov_max,
        block_h=32, interpret=True)
    _assert_decode(got, x, y, z, pu)


def test_decode_masks_dark_pixels_as_holes():
    """All-black phase images with min_modulation: every pixel is a hole
    (P == 0 and z == 0), no NaNs (slc_tpu/pipeline.py:94-96)."""
    _, cfg, _, tt, scene = _scene(96, 160)
    dark = np.zeros_like(scene.phase_images)
    got = decode_first_frame(torch.from_numpy(scene.gray_images),
                             torch.from_numpy(dark), tt, cfg,
                             min_modulation=2.0)
    assert (got.proj_u == 0).all() and (got.z == 0).all()
    assert torch.isfinite(got.x).all()


def test_gray_to_binary_inverts_gray_code():
    b = torch.arange(1 << 10, dtype=torch.int32)
    np.testing.assert_array_equal(tgray.gray_to_binary(b ^ (b >> 1), 10),
                                  b)


def test_decode_cuda_tensor_without_card_raises():
    """A tensor on any device but the CPU goes to the kernel: there is no
    fallback to the plain path."""
    from slc_tpu_torch.kernels.grayphase import grayphase_decode
    _, cfg, _, tt, scene = _scene(96, 160)
    meta = torch.empty(scene.gray_images.shape, dtype=torch.uint8,
                       device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        grayphase_decode(meta, meta, tt, cfg)
