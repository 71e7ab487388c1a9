"""slc_tpu_torch.golden, the port's copy of slc_tpu's float64 oracle:
equal to slc_tpu.golden bit for bit on random inputs, function by
function; and the port's plain ops against it at slc_tpu's bars
(decode_phase 2e-4, the merge 1e-3, triangulate 5e-3, box_blur_3x3
1e-5, the dynamic step 1e-3; tests/test_decode.py,
tests/test_triangulate.py, tests/test_filters.py, tests/test_stripe.py)."""

import numpy as np
import pytest
import torch

from slc_tpu import golden as jgolden

from slc_tpu_torch import golden
from slc_tpu_torch.calib import (Calibration, build_tables,
                                 synthetic_calibration)
from slc_tpu_torch.kernels.dynamic_step import dynamic_step_open
from slc_tpu_torch.kernels.stripe import stripe_regression
from slc_tpu_torch.ops.filters import box_blur_3x3
from slc_tpu_torch.ops.gray import decode_gray
from slc_tpu_torch.ops.phase import decode_phase
from slc_tpu_torch.ops.triangulate import triangulate_xyz
from slc_tpu_torch.ops.unwrap import gray_assisted_merge

torch.set_num_threads(2)

H, W = 24, 40


def _same(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _calib():
    return synthetic_calibration(cam_h=H, cam_w=W, pro_h=96, pro_w=640)


def _cases(rng):
    calib = _calib()
    cam_k, pro_mat = np.asarray(calib.cam_k, np.float64), calib.pro_mat()
    frame = rng.integers(0, 256, (H, W), dtype=np.uint8)
    gray = rng.integers(0, 256, (10, H, W), dtype=np.uint8)
    vs = golden.box_sum_vertical(frame, 7)
    pu = rng.uniform(0, 640, (H, W))
    return {
        "decode_phase": ((rng.integers(0, 256, (4, H, W)).astype(np.uint8),
                          24.0), {}),
        "decode_gray": ((gray, 5, 640), {}),
        "gray_assisted_merge": ((rng.uniform(0, 640, (H, W)),
                                 rng.uniform(0, 24, (H, W)), 20.0, 24.0), {}),
        "triangulation_tables": ((cam_k, pro_mat, H, W), {}),
        "triangulate": ((pu, cam_k, pro_mat, 10.0, 100.0), {}),
        "box_sum_vertical": ((frame, 7), {}),
        "windowed_extrema": ((vs, 7), {}),
        "box_blur_3x3": ((rng.normal(size=(H, W)),), {}),
        "dynamic_step": ((pu, rng.normal(size=(H, W)),
                          rng.normal(size=(H, W)), frame, 7), {}),
    }


def test_copy_covers_every_function():
    public = {n for n in dir(jgolden) if callable(getattr(jgolden, n))
              and not n.startswith("_")
              and getattr(jgolden, n).__module__ == jgolden.__name__}
    assert public == set(_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("name", sorted(_cases(np.random.default_rng(0))))
def test_copy_equals_slc_tpu_golden(name):
    args, kw = _cases(np.random.default_rng(7))[name]
    _same(getattr(golden, name)(*args, **kw),
          getattr(jgolden, name)(*args, **kw))


def test_phase_and_gray_against_golden(rng):
    """tests/test_decode.py's golden cases on the port's ops."""
    imgs = rng.integers(0, 256, size=(4, 16, 32), dtype=np.uint8)
    np.testing.assert_allclose(decode_phase(torch.from_numpy(imgs),
                                            40.0).numpy(),
                               golden.decode_phase(imgs, 40.0), atol=2e-4)
    gray = rng.integers(0, 256, size=(10, 8, 16), dtype=np.uint8)
    np.testing.assert_array_equal(
        decode_gray(torch.from_numpy(gray), 5, 640).numpy(),
        golden.decode_gray(gray, 5, 640))
    g = rng.integers(0, 64, size=(32, 48)).astype(np.float64) * 20.0
    phase = rng.uniform(0.0, 40.0, size=(32, 48))
    merged = gray_assisted_merge(torch.from_numpy(g.astype(np.float32)),
                                 torch.from_numpy(phase.astype(np.float32)),
                                 20.0, 40.0)
    np.testing.assert_allclose(
        merged.numpy(), golden.gray_assisted_merge(g, phase, 20.0, 40.0),
        rtol=0, atol=1e-3)


def test_triangulate_and_blur_against_golden(rng):
    """tests/test_triangulate.py:38-56 and :75-88 and
    tests/test_filters.py's golden cases on the port's ops."""
    calib = Calibration.reference_example()
    cam_k = np.asarray(calib.cam_k, np.float64)
    h, w = 256, 320
    pu = np.random.default_rng(7).uniform(200.0, 1000.0, size=(h, w))
    x, y, z = triangulate_xyz(torch.from_numpy(pu.astype(np.float32)),
                              build_tables(calib, h, w, device="cpu"),
                              10.0, 100.0)
    gx, gy, gz = golden.triangulate(pu, cam_k, calib.pro_mat(), 10.0, 100.0)
    valid = gz != 0
    assert valid.mean() > 0.1
    assert np.abs(z.numpy() - gz)[valid].max() < 5e-3
    np.testing.assert_allclose(x.numpy(), gx, atol=5e-3)
    np.testing.assert_allclose(y.numpy(), gy, atol=5e-3)

    b = rng.normal(size=(H, W)).astype(np.float32)
    np.testing.assert_allclose(box_blur_3x3(torch.from_numpy(b)).numpy(),
                               golden.box_blur_3x3(b), atol=1e-5)


def test_dynamic_step_against_golden(rng):
    """The open-loop step with the reference's semantics (no sub-pixel,
    no gradient scale, no robust combine) against golden.dynamic_step on
    random frames (tests/test_stripe.py:68-84)."""
    h, w, window = 48, 64, 7
    f0 = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    f1 = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    pu0 = rng.uniform(100.0, 500.0, size=(h, w))
    sw0, sb0 = stripe_regression(torch.from_numpy(f0), window,
                                 subpixel=False)
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    pu1, sw1, sb1, _, _, _ = dynamic_step_open(
        torch.from_numpy(f1), sw0, sb0,
        torch.from_numpy(pu0.astype(np.float32)),
        build_tables(calib, h, w, device="cpu"), window=window,
        subpixel=False, scale_gradient=False, robust=False)
    gw0, gb0 = golden.windowed_extrema(golden.box_sum_vertical(f0, window),
                                       window)
    g_pu1, g_sw1, g_sb1, _ = golden.dynamic_step(pu0, gw0, gb0, f1, window)
    np.testing.assert_array_equal(sw0.numpy(), gw0)
    np.testing.assert_array_equal(sw1.numpy(), g_sw1)
    np.testing.assert_array_equal(sb1.numpy(), g_sb1)
    np.testing.assert_allclose(pu1.numpy(), g_pu1, atol=1e-3)
