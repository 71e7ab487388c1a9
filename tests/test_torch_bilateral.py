"""slc_tpu_torch's bilateral depth filter (the plain version the kernel is
held to) against slc_tpu, with the port's border semantics: out-of-image
neighbours are missing, as in slc_tpu's TPU kernel. So the plain version
matches the Pallas kernel in interpret mode on every pixel, and the XLA
path, which wraps, on the interior [1:-1, 1:-1]; both to 1e-4, the bar of
tests/test_filters.py:62."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu.ops.filters import bilateral_filter as j_bilateral
from slc_tpu.pallas.bilateral import bilateral_filter_pallas

from slc_tpu_torch.kernels.bilateral import bilateral_filter
from slc_tpu_torch.ops import filters

torch.set_num_threads(2)


def _depth_with_holes(h, w, seed=1234):
    rng = np.random.default_rng(seed)
    z = 50.0 + rng.normal(0, 0.4, size=(h, w)).astype(np.float32)
    z[rng.uniform(size=(h, w)) < 0.05] = 0.0
    return z


@pytest.mark.parametrize("shape", [(72, 100), (64, 128)])
def test_bilateral_matches_pallas_everywhere_and_xla_inside(shape):
    z = _depth_with_holes(*shape)
    got = bilateral_filter(torch.from_numpy(z)).numpy()
    pallas = np.asarray(bilateral_filter_pallas(jnp.asarray(z), block_h=32,
                                                interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-4)
    xla = np.asarray(j_bilateral(jnp.asarray(z), use_pallas=False))
    np.testing.assert_allclose(got[1:-1, 1:-1], xla[1:-1, 1:-1], atol=1e-4)
    # Holes stay holes; valid pixels stay valid.
    np.testing.assert_array_equal(got == 0.0, z == 0.0)


def test_bilateral_no_edge_wrap_at_lane_multiple_width():
    """Width a multiple of 128 (the reference camera's 1280 is one): the
    left border must not see the right one (tests/test_filters.py:68-80)."""
    z = np.full((16, 128), 50.0, np.float32)
    z[:, -1] = 80.0
    got = bilateral_filter(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got[:, 0], 50.0, atol=1e-5)
    pallas = np.asarray(bilateral_filter_pallas(jnp.asarray(z), block_h=16,
                                                interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-4)


def test_bilateral_smooths_noise_keeps_edges():
    """tests/test_filters.py:23-39 on the port: noise reduced on the
    flats, the step edge kept."""
    rng = np.random.default_rng(1234)
    h, w = 64, 64
    img = np.broadcast_to(np.where(np.arange(w)[None, :] < w // 2, 40.0,
                                   70.0), (h, w)).copy()
    noisy = (img + rng.normal(0, 0.5, size=(h, w))).astype(np.float32)
    out = bilateral_filter(torch.from_numpy(noisy)).numpy()
    flat = (slice(8, -8), slice(8, w // 2 - 4))
    assert np.std(out[flat] - img[flat]) < 0.7 * np.std(noisy[flat]
                                                         - img[flat])
    edge_in = abs(noisy[:, w // 2 + 1].mean() - noisy[:, w // 2 - 2].mean())
    edge_out = abs(out[:, w // 2 + 1].mean() - out[:, w // 2 - 2].mean())
    assert edge_out > 0.9 * edge_in


def test_bilateral_not_hole_aware_on_cpu_matches_xla_inside():
    z = _depth_with_holes(40, 56)
    got = filters.bilateral_filter(torch.from_numpy(z),
                                   hole_aware=False).numpy()
    xla = np.asarray(j_bilateral(jnp.asarray(z), hole_aware=False,
                                 use_pallas=False))
    np.testing.assert_allclose(got[1:-1, 1:-1], xla[1:-1, 1:-1], atol=1e-4)


def test_bilateral_kernel_forms_only():
    """Off the CPU only the hole-aware 3x3 filter exists (the kernel's
    form), and there is no fallback to the plain version."""
    meta = torch.empty((8, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="hole-aware"):
        bilateral_filter(meta, hole_aware=False)
    with pytest.raises(ValueError, match="hole-aware"):
        bilateral_filter(meta, radius=2)
    with pytest.raises((ValueError, RuntimeError)):
        bilateral_filter(meta)
