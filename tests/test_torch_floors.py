"""The access-pattern floor (slc_tpu_torch.kernels.floors: the plain path
its kernel is held to) against slc_tpu's ``halo_block_floor`` semantics.
The Pallas floor has no interpret switch (slc_tpu/pallas/floors.py:24-25),
so the plain version is held against its output expression written in
jnp (floors.py:59-64), exactly, for u8 and float32 images and 1 and 2
outputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu_torch.kernels import floors as kfl

torch.set_num_threads(2)


def _image(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, np.uint8)
    return (50.0 + rng.normal(0, 0.4, shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(96, 160), (90, 150)])
@pytest.mark.parametrize("dtype,halo", [(np.uint8, 10), (np.float32, 1)])
@pytest.mark.parametrize("n_out", [1, 2])
def test_floor_plain_matches_jnp_expression(shape, dtype, halo, n_out):
    img = _image(shape, dtype)
    x = jnp.asarray(img)
    if x.dtype == jnp.uint8:
        x = x.astype(jnp.int32)
    x = x.astype(jnp.float32)
    want = [x + jnp.float32(k) for k in range(n_out)]
    got = kfl.halo_block_floor(torch.from_numpy(img), halo=halo, n_out=n_out)
    assert len(got) == n_out
    for g, e in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_floor_kernel_rejects_cpu_tensors_and_bad_args():
    img = torch.from_numpy(_image((96, 160), np.uint8))
    before = kfl.halo_block_floor_cuda.launches
    with pytest.raises(ValueError, match="cuda"):
        kfl.halo_block_floor_cuda(img)
    assert kfl.halo_block_floor_cuda.launches == before
    with pytest.raises(ValueError, match="n_out"):
        kfl.halo_block_floor(img, n_out=0)
    with pytest.raises(ValueError, match="halo"):
        kfl.halo_block_floor(img, halo=32)
    with pytest.raises(TypeError, match="uint8 or float32"):
        kfl.halo_block_floor(img.to(torch.int16))
