"""The standalone phase lock (slc_tpu_torch.kernels.phaselock: the plain
path its kernel is held to) against slc_tpu's Pallas ``phase_lock_pallas``
in interpret mode and against slc_tpu's XLA composite (ops.demod +
ops.triangulate), from a synth-rendered frame and a prediction 1.3 px off
with a hole band. Bars as tests/test_pallas.py:329-335 holds the Pallas
kernel to the composite: P 2e-3, z and x 4e-3, the hole band unchanged."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.ops.demod import stripe_phase_correction as j_correction
from slc_tpu.ops.triangulate import triangulate_xyz as j_triangulate
from slc_tpu.pallas.phaselock import phase_lock_pallas

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch.kernels import phaselock as kpl
from slc_tpu_torch.ops.demod import GATE_BAND

torch.set_num_threads(2)

SHAPES = [(96, 160), (90, 150)]
PERIOD = 12.0
BARS = (2e-3, 4e-3, 4e-3, 4e-3)          # P, z, x, y


def _setup(h, w):
    jcfg = JConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640, gray_bits=5)
    jc = jcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    tc = tcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    frames, _, pu_gt = jsynth.render_dynamic_sequence(
        jc, jcfg, 2, stripe_period=int(PERIOD), noise_sigma=1.0)
    pred = np.asarray(pu_gt[1] + 1.3, np.float32)
    pred[:, 40:48] = 0.0                  # a hole band stays a hole
    return (jcfg, jcalib.build_tables(jc, h, w),
            tcalib.build_tables(tc, h, w, device="cpu"), frames[1], pred)


def _pallas(jcfg, jt, frame, pred, period, win_u):
    scal = jnp.stack([jt.a, jt.b, jt.fx, jt.fy, jt.cx, jt.cy,
                      jnp.float32(0.0), jnp.float32(0.0)]).reshape(1, 8)
    return phase_lock_pallas(
        jnp.asarray(frame), jnp.asarray(pred), jt.c, jt.d, scal,
        period=period, win_u=win_u, win_v=9, fov_min=jcfg.fov_min,
        fov_max=jcfg.fov_max, block_h=GATE_BAND, interpret=True)


def _xla(jcfg, jt, frame, pred, period, win_u):
    p = jnp.asarray(pred)
    dp, _ = j_correction(jnp.asarray(frame), p, period, win_u, 9)
    pu = p + dp
    x, y, z = j_triangulate(pu, jt, jcfg.fov_min, jcfg.fov_max)
    return pu, z, x, y


def _ours(jcfg, tt, frame, pred, period, win_u):
    return kpl.phase_lock(torch.from_numpy(frame), torch.from_numpy(pred),
                          tt, period=period, win_u=win_u, win_v=9,
                          fov_min=jcfg.fov_min, fov_max=jcfg.fov_max)


def _check(got, want, pred):
    for g, e, bar in zip(got, want, BARS):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=bar)
    assert np.all(got[0].numpy()[:, 42:46] == pred[:, 42:46])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("win_u", [21, 13])
def test_phase_lock_matches_pallas(shape, win_u):
    jcfg, jt, tt, frame, pred = _setup(*shape)
    got = _ours(jcfg, tt, frame, pred, PERIOD, win_u)
    _check(got, _pallas(jcfg, jt, frame, pred, PERIOD, win_u), pred)


@pytest.mark.parametrize("shape", SHAPES)
def test_phase_lock_matches_xla(shape):
    jcfg, jt, tt, frame, pred = _setup(*shape)
    got = _ours(jcfg, tt, frame, pred, PERIOD, 21)
    _check(got, _xla(jcfg, jt, frame, pred, PERIOD, 21), pred)


def _gated_bands(pu, pred, h):
    """Per GATE_BAND-row band: True where no pixel was corrected."""
    moved = np.asarray(pu) != pred
    return [not moved[b:b + GATE_BAND].any() for b in range(0, h, GATE_BAND)]


@pytest.mark.parametrize("shape", SHAPES)
def test_phase_lock_gate_trips_band_for_band(shape):
    """A lock period 3% wrong leaves a constant carrier gradient that the
    gate must catch: the port gates the same bands as the Pallas kernel
    and the XLA path (each band either fully corrected or not at all),
    and agrees with both on every pixel."""
    jcfg, jt, tt, frame, pred = _setup(*shape)
    period = PERIOD * 1.03
    got = _ours(jcfg, tt, frame, pred, period, 21)
    bands = _gated_bands(got[0].numpy(), pred, shape[0])
    assert any(bands), "the gate never tripped at a 3% period error"
    for want in (_pallas(jcfg, jt, frame, pred, period, 21),
                 _xla(jcfg, jt, frame, pred, period, 21)):
        assert _gated_bands(want[0], pred, shape[0]) == bands
        _check(got, want, pred)


def test_phase_lock_leaves_the_prediction_and_counts_no_launch():
    jcfg, _, tt, frame, pred = _setup(96, 160)
    before = kpl.phase_lock_cuda.launches
    p = torch.from_numpy(pred.copy())
    kpl.phase_lock(torch.from_numpy(frame), p, tt, period=PERIOD, win_u=21)
    assert torch.equal(p, torch.from_numpy(pred))
    assert kpl.phase_lock_cuda.launches == before


def test_phase_lock_kernel_rejects_cpu_tensors_and_bad_args():
    _, _, tt, frame, pred = _setup(96, 160)
    f, p = torch.from_numpy(frame), torch.from_numpy(pred)
    with pytest.raises(ValueError, match="cuda"):
        kpl.phase_lock_cuda(f, p, tt, period=PERIOD)
    with pytest.raises(ValueError, match="win_u"):
        kpl.phase_lock_cuda(f, p, tt, period=PERIOD, win_u=8)
    with pytest.raises(ValueError, match="period"):
        kpl.phase_lock_cuda(f, p, tt, period=float("inf"))
