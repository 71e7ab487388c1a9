"""Phase-lock demodulation (slc_tpu_torch.ops.demod) against
slc_tpu.ops.demod on rendered stripe frames: correction to 2e-3 px,
period to 1e-4 relative, lock window exact (by the host path and by the
card path's finish from the plain middle values), and the carrier gate's
per-band decisions identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.ops import demod as jdemod

from slc_tpu_torch import metrics
from slc_tpu_torch.kernels import lock_window as klw
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


@pytest.fixture(scope="module")
def decoded_pu():
    return np.asarray(_sequence(96, 160)[2][0], np.float32)


LOCK_CASES = ["decoded", "holes", "left_zero", "mirrored", "ties", "none",
              "half", "ragged"]


def _lock_case(case, decoded):
    """A float32 map for the lock window: the rendered P, with holes, with
    its left columns zeroed, mirrored (negative gradients), a map of two
    gradients (ties), one with nothing valid, a constant gradient of 0.5,
    a ragged random map."""
    rng = np.random.default_rng(5)
    u = np.arange(150, dtype=np.float32)
    if case == "holes":
        return np.where(rng.uniform(size=decoded.shape) < 0.05, 0.0,
                        decoded).astype(np.float32)
    if case == "left_zero":
        pu = decoded.copy()
        pu[:, :60] = 0.0
        return pu
    if case == "mirrored":
        return np.ascontiguousarray(decoded[:, ::-1])
    if case == "ties":
        pu = np.tile(0.5 * u + 1.0, (90, 1))
        pu[::3] = 0.75 * u + 1.0
        return pu
    if case == "none":
        return np.full((90, 150), -1.0, np.float32)
    if case == "half":
        return np.tile(0.5 * u + 1.0, (90, 1))
    if case == "ragged":
        return np.cumsum(rng.uniform(0.3, 0.9, (90, 150)), 1).astype(
            np.float32)
    return decoded


@pytest.mark.parametrize("case", LOCK_CASES)
def test_middle_gradients_are_numpys_median(decoded_pu, case):
    """The plain version's n and two middle values are the sorted |g|'s,
    and their mean is np.median bit for bit: the finish the card path
    takes."""
    pu = _lock_case(case, decoded_pu)
    n, lo, hi = klw.middle_abs_gradients_ref(pu)
    a = np.sort(klw.valid_abs_gradients(pu))
    assert n == a.size and (n == 0) == (case == "none")
    if n:
        assert (lo, hi) == (a[(n - 1) // 2], a[n // 2])
        assert (np.float64(np.mean([lo, hi])).view(np.int64)
                == np.float64(np.median(a)).view(np.int64))


@pytest.mark.parametrize("case", LOCK_CASES)
@pytest.mark.parametrize("period", [10.25, 12.0, 200.0])
def test_card_branch_window_matches_jax(monkeypatch, decoded_pu, case,
                                        period):
    """The card branch of suggest_lock_window, fed the plain middle values
    (a CPU tensor standing in for the card's), gives slc_tpu's window
    (10.25 on the constant gradient 0.5 lands on 20.5: round to even) and
    counts ``setup.lock_window_card`` once under a profiler."""
    pu = _lock_case(case, decoded_pu)
    monkeypatch.setattr(tdemod, "_on_card", torch.from_numpy)
    metrics.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        win = tdemod.suggest_lock_window(pu, period)
    assert win == jdemod.suggest_lock_window(pu, period)
    if case == "half" and period == 10.25:
        assert win == 19
    assert metrics.counters() == {"setup.lock_window_card": 1}
    metrics.reset()


@pytest.mark.parametrize("form", ["cpu_tensor", "float64", "float32"])
@pytest.mark.parametrize("period", [12.0, 20.0, 200.0])
def test_host_inputs_take_the_numpy_path(monkeypatch, decoded_pu, form,
                                         period):
    """With no card, a float32 map, a CPU tensor and a float64 map take
    the host path (no counter) and give slc_tpu's window."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pu = _lock_case("left_zero", decoded_pu)
    arg = {"cpu_tensor": torch.from_numpy(pu),
           "float64": pu.astype(np.float64), "float32": pu}[form]
    assert tdemod._on_card(arg) is None
    metrics.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        win = tdemod.suggest_lock_window(arg, period)
    assert win == jdemod.suggest_lock_window(pu, period)
    assert metrics.counters() == {}
    assert metrics.span_totals()["setup.lock_window"]["calls"] == 1
    metrics.reset()


@pytest.mark.parametrize("n, win", [(160, 21), (90, 9), (150, 63), (7, 9)])
def test_tri_weights_match_jax(n, win):
    want = np.asarray(jdemod._tri_weight(1, n, 1, win))[0]
    np.testing.assert_array_equal(tdemod.tri_weights_1d(n, win), want)
