"""Phase-lock demodulation (slc_tpu_torch.ops.demod) against
slc_tpu.ops.demod on rendered stripe frames: correction to 2e-3 px,
period to 1e-4 relative, lock window exact, and the carrier gate's
per-band decisions identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.ops import demod as jdemod

from slc_tpu_torch.ops import demod as tdemod

torch.set_num_threads(2)


def _sequence(h, w, frames=2, dz=0.05):
    cfg = JConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640, gray_bits=5)
    calib = jcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96,
                                         pro_w=640)
    return jsynth.render_dynamic_sequence(calib, cfg, frames,
                                          dz_per_frame=dz, stripe_period=12,
                                          noise_sigma=1.0)


def _both(frame, pred, period, win_u, **kw):
    dj, aj = jdemod.stripe_phase_correction(jnp.asarray(frame),
                                            jnp.asarray(pred), period,
                                            win_u, 9, **kw)
    dt, at = tdemod.stripe_phase_correction(torch.from_numpy(frame),
                                            torch.from_numpy(pred), period,
                                            win_u, 9, **kw)
    return dt.numpy(), at.numpy(), np.asarray(dj), np.asarray(aj)


@pytest.mark.parametrize("shape", [(96, 160), (90, 150)])
@pytest.mark.parametrize("win_u", [9, 21])
def test_stripe_phase_correction_matches_jax(shape, win_u):
    frames, _, pu_gt = _sequence(*shape)
    pred = np.asarray(pu_gt[1] + 1.3, np.float32)
    pred[:, 40:48] = 0.0                       # a hole band stays a hole
    dt, at, dj, aj = _both(frames[1], pred, 12.0, win_u)
    np.testing.assert_allclose(dt, dj, atol=2e-3)
    np.testing.assert_allclose(at, aj, rtol=1e-4, atol=1e-3)
    assert (dt[:, 40:48] == 0).all()


def _band_locked(dp, band):
    return [bool((dp[i:i + band] != 0).any())
            for i in range(0, dp.shape[0], band)]


@pytest.mark.parametrize("case", ["period_3pct_wrong", "band0_gradient",
                                  "correct"])
def test_carrier_gate_bands_match_jax(case):
    """The gate zeroes whole GATE_BAND-row bands: a 3% wrong lock period
    trips every band, a gradient added to the prediction of band 0 only
    trips band 0, and the right period trips none. Both packages must
    take the same decision in every band."""
    h, w = 192, 160
    frames, _, pu_gt = _sequence(h, w)
    pred = np.asarray(pu_gt[1], np.float32)
    period = 12.0
    if case == "period_3pct_wrong":
        period = 12.0 * 1.03
    elif case == "band0_gradient":
        ramp = 0.01 * np.arange(w, dtype=np.float32)[None, :]
        pred[:tdemod.GATE_BAND] += ramp
    dt, _, dj, _ = _both(frames[1], pred, period, 21)
    got = _band_locked(dt, tdemod.GATE_BAND)
    want = _band_locked(dj, jdemod.GATE_BAND)
    assert got == want
    expected = {"period_3pct_wrong": [False] * 3,
                "band0_gradient": [False, True, True],
                "correct": [True] * 3}[case]
    assert got == expected
    np.testing.assert_allclose(dt, dj, atol=2e-3)


def test_gate_threshold_zero_means_off():
    """max_carrier_gradient 0 disables the gate (slc_tpu/ops/demod.py:204),
    so even a 3% wrong period locks every band."""
    frames, _, pu_gt = _sequence(192, 160)
    pred = np.asarray(pu_gt[1], np.float32)
    dt, _, dj, _ = _both(frames[1], pred, 12.36, 21, max_carrier_gradient=0)
    assert _band_locked(dt, tdemod.GATE_BAND) == [True] * 3
    np.testing.assert_allclose(dt, dj, atol=2e-3)


@pytest.mark.parametrize("nominal", [12.0, 12.0 * 1.05, 12.0 * 0.93])
def test_estimate_period_matches_jax(nominal):
    frames, _, pu_gt = _sequence(96, 160)
    pu = np.asarray(pu_gt[1], np.float32)
    tj = float(jdemod.estimate_period(jnp.asarray(frames[1]),
                                      jnp.asarray(pu), nominal, win_u=21))
    tt = float(tdemod.estimate_period(torch.from_numpy(frames[1]),
                                      torch.from_numpy(pu), nominal,
                                      win_u=21))
    assert abs(tt / tj - 1.0) < 1e-4, (tt, tj)
    assert abs(tt / 12.0 - 1.0) < 0.01       # it finds the true period


@pytest.mark.parametrize("period", [12.0, 20.0, 200.0])
def test_suggest_lock_window_identical(period):
    _, _, pu_gt = _sequence(96, 160)
    pu = np.asarray(pu_gt[0], np.float32)
    pu[:, :5] = 0.0
    assert (tdemod.suggest_lock_window(pu, period)
            == jdemod.suggest_lock_window(pu, period))


@pytest.mark.parametrize("n, win", [(160, 21), (90, 9), (150, 63), (7, 9)])
def test_tri_weights_match_jax(n, win):
    want = np.asarray(jdemod._tri_weight(1, n, 1, win))[0]
    np.testing.assert_array_equal(tdemod.tri_weights_1d(n, win), want)
