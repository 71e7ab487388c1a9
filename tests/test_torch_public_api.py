"""slc_tpu's last public functions in slc_tpu_torch, against slc_tpu on
seeded numpy inputs on the CPU: the Gray helpers and ``delta_z``
exactly, ``absolute_projector_map`` at the decode's 2e-3 on P, the plain
``ops.stripe.stripe_regression`` at the stripe bar 1e-5, and the package
exports by name."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slc_tpu
import slc_tpu.io
import slc_tpu.ops
from slc_tpu import synth as jsynth
from slc_tpu.calib import synthetic_calibration
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.dynamic import delta_z as j_delta_z
from slc_tpu.ops import gray as jgray
from slc_tpu.ops.stripe import stripe_regression as j_stripe_regression
from slc_tpu.pipeline import absolute_projector_map as j_apm

import slc_tpu_torch
import slc_tpu_torch.io
import slc_tpu_torch.ops
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.dynamic import delta_z
from slc_tpu_torch.ops import gray as tgray
from slc_tpu_torch.ops.stripe import stripe_regression
from slc_tpu_torch.pipeline import absolute_projector_map

torch.set_num_threads(2)

_SHAPE = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)


@pytest.mark.parametrize("pkg, want", [
    (slc_tpu_torch, slc_tpu), (slc_tpu_torch.ops, slc_tpu.ops),
    (slc_tpu_torch.io, slc_tpu.io)])
def test_exports_match_slc_tpu(pkg, want):
    assert pkg.__all__ == want.__all__
    for name in pkg.__all__:
        assert callable(getattr(pkg, name)) or name == "REFERENCE_CONFIG"


@pytest.mark.parametrize("bits", [1, 5, 6, 10])
def test_gray_code_round_trip_matches_jax(bits):
    b = np.arange(1 << bits, dtype=np.int32)
    g = tgray.binary_to_gray(torch.from_numpy(b))
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jgray.binary_to_gray(jnp.asarray(b))))
    np.testing.assert_array_equal(tgray.gray_to_binary(g, bits).numpy(), b)
    # Neighbouring codes differ in one bit.
    diff = (g[1:] ^ g[:-1]).numpy()
    assert ((diff & (diff - 1)) == 0).all() and (diff > 0).all()


@pytest.mark.parametrize("bits", [5, 6])
def test_gray_bits_and_bins_match_jax(bits):
    rng = np.random.default_rng(bits)
    imgs = rng.integers(0, 256, (2 * bits + 2, 37, 53), dtype=np.uint8)
    imgs[1, :4] = imgs[0, :4]                  # ties read as 0
    t, j = torch.from_numpy(imgs), jnp.asarray(imgs)
    got = tgray.binarize_bits(t, bits)
    assert got.dtype == torch.bool and got.shape == (bits, 37, 53)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jgray.binarize_bits(j, bits)))
    bins = tgray.decode_gray_bins(t, bits)
    assert bins.dtype == torch.int32
    np.testing.assert_array_equal(bins.numpy(),
                                  np.asarray(jgray.decode_gray_bins(j, bits)))
    np.testing.assert_array_equal(
        tgray.decode_gray(t, bits, 1280).numpy(),
        np.asarray(jgray.decode_gray(j, bits, 1280)))


def test_delta_z_matches_jax():
    z = np.random.default_rng(1).normal(50.0, 2.0, (5, 16, 24))
    z = z.astype(np.float32)
    got = delta_z(torch.from_numpy(z))
    assert got.shape == (4, 16, 24)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_delta_z(jnp.asarray(z))))


@pytest.mark.parametrize("surface", ["plane", "sphere"])
def test_absolute_projector_map_matches_jax(surface):
    jcfg, cfg = JConfig(**_SHAPE), SystemConfig(**_SHAPE)
    calib = synthetic_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    shape = (jsynth.plane_surface(50.0) if surface == "plane"
             else jsynth.sphere_surface())
    scene = jsynth.render_static_scene(calib, jcfg, shape, noise_sigma=1.0)
    got = absolute_projector_map(torch.from_numpy(scene.gray_images),
                                 torch.from_numpy(scene.phase_images), cfg)
    want = j_apm(jnp.asarray(scene.gray_images),
                 jnp.asarray(scene.phase_images), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("window", [5, 21])
def test_plain_stripe_regression_matches_jax(subpixel, window):
    frame = np.random.default_rng(window).integers(0, 256, (64, 96),
                                                   dtype=np.uint8)
    got = stripe_regression(torch.from_numpy(frame), window, subpixel)
    want = j_stripe_regression(jnp.asarray(frame), window, subpixel)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
