"""Stripe tracking (slc_tpu_torch.kernels.stripe's plain path, which the
CUDA kernel is held to), select_delta_p and box_blur_3x3 against
slc_tpu's XLA ops and the Pallas stripe kernel in interpret mode. Strip
offsets to 1e-5 (they are expected to be equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu.ops.filters import box_blur_3x3 as j_blur
from slc_tpu.ops.stripe import box_sum_vertical_raw as j_box_raw
from slc_tpu.ops.stripe import select_delta_p as j_select
from slc_tpu.ops.stripe import stripe_regression as j_stripe
from slc_tpu.ops.stripe import windowed_extrema_raw as j_extrema_raw
from slc_tpu.pallas.stripe import stripe_regression_pallas

from slc_tpu_torch.kernels.stripe import stripe_regression
from slc_tpu_torch.ops.filters import box_blur_3x3
from slc_tpu_torch.ops.stripe import (box_sum_vertical,
                                      box_sum_vertical_raw, select_delta_p,
                                      windowed_extrema, windowed_extrema_raw)

torch.set_num_threads(2)


@pytest.mark.parametrize("window", [5, 21, 63])
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("shape", [(96, 160), (100, 200)])
def test_stripe_regression_matches_jax(rng, window, subpixel, shape):
    """Windows 5..63, the kernels' range (check_window); at r = 31 both
    shapes keep an interior of 34+ rows."""
    frame = rng.integers(0, 256, size=shape, dtype=np.uint8)
    sw, sb = stripe_regression(torch.from_numpy(frame), window, subpixel)
    xw, xb = j_stripe(jnp.asarray(frame), window, subpixel)
    pw, pb = stripe_regression_pallas(jnp.asarray(frame), window, subpixel,
                                      block_h=32, interpret=True)
    for want_w, want_b in ((xw, xb), (pw, pb)):
        np.testing.assert_allclose(sw.numpy(), np.asarray(want_w), atol=1e-5)
        np.testing.assert_allclose(sb.numpy(), np.asarray(want_b), atol=1e-5)


@pytest.mark.parametrize("levels", [2, 6])
def test_stripe_tie_break_matches_jax(rng, levels):
    """Few distinct values make dense ties: the center wins a tie,
    otherwise the leftmost offset (CCalculation.cpp:828-891)."""
    frame = (rng.integers(0, levels, size=(64, 128)) * (255 // (levels - 1))
             ).astype(np.uint8)
    for subpixel in (False, True):
        sw, sb = stripe_regression(torch.from_numpy(frame), 21, subpixel)
        xw, xb = j_stripe(jnp.asarray(frame), 21, subpixel)
        np.testing.assert_array_equal(sw.numpy(), np.asarray(xw))
        np.testing.assert_array_equal(sb.numpy(), np.asarray(xb))


@pytest.mark.parametrize("robust", [False, True])
def test_select_delta_p_matches_jax(rng, robust):
    a, b, c, d = (rng.uniform(-5, 5, (48, 64)).astype(np.float32)
                  for _ in range(4))
    got = select_delta_p(*(torch.from_numpy(v) for v in (a, b, c, d)),
                         robust=robust)
    want = j_select(*(jnp.asarray(v) for v in (a, b, c, d)), robust=robust)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(96, 160), (90, 150)])
def test_box_blur_3x3_matches_jax(rng, shape):
    x = rng.normal(0, 3, shape).astype(np.float32)
    np.testing.assert_allclose(box_blur_3x3(torch.from_numpy(x)).numpy(),
                               np.asarray(j_blur(jnp.asarray(x))),
                               atol=1e-5)


def test_stripe_rejects_windows_the_kernel_cannot_take():
    from slc_tpu_torch.kernels.stripe import stripe_regression_cuda
    frame = torch.zeros((32, 32), dtype=torch.uint8)
    for window in (4, 3, 65):
        with pytest.raises(ValueError, match="window"):
            stripe_regression_cuda(frame, window)
    with pytest.raises(ValueError, match="cuda"):
        stripe_regression_cuda(frame, 21)


@pytest.mark.parametrize("window", [5, 21])
@pytest.mark.parametrize("subpixel", [False, True])
def test_raw_stencils_match_jax(rng, window, subpixel):
    """The unmasked cores the tile-parallel paths share
    (slc_tpu/ops/stripe.py:35,68), border pixels included; the masked
    stencils are the raw ones with the interior mask."""
    frame = rng.integers(0, 256, size=(64, 96), dtype=np.uint8)
    box = box_sum_vertical_raw(torch.from_numpy(frame), window)
    jbox = j_box_raw(jnp.asarray(frame), window)
    np.testing.assert_array_equal(box.numpy(), np.asarray(jbox))
    raw = windowed_extrema_raw(box, window, subpixel)
    for got, want in zip(raw, j_extrema_raw(jbox, window, subpixel)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    r = window // 2
    inner = np.zeros(frame.shape, bool)
    inner[r:-r, r:-r] = True
    masked = box_sum_vertical(torch.from_numpy(frame), window).numpy()
    np.testing.assert_array_equal(masked, np.where(inner, box.numpy(), 0))
    for got, want in zip(windowed_extrema(box, window, subpixel), raw):
        np.testing.assert_array_equal(got.numpy(),
                                      np.where(inner, want.numpy(), 0))
