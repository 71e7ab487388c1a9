"""The tracker step (slc_tpu_torch.dynamic: the plain paths the two step
kernels are held to) against slc_tpu's XLA composite and its Pallas step
kernels in interpret mode, from a synth-rendered state
(tests/test_pallas.py:351-384). Bars: locked P 2e-3, z and x 4e-3,
strips 1e-5; open loop P 2e-4, z 2e-3, x 2e-4 (test_pallas.py:62-71)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.dynamic import dynamic_step as j_step
from slc_tpu.dynamic import init_tracker as j_init
from slc_tpu.pallas.dynamic_lock import dynamic_step_lock_pallas
from slc_tpu.pallas.dynamic_step import dynamic_step_pallas

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.dynamic import TrackerState, dynamic_step, init_tracker

torch.set_num_threads(2)

_STATE = ("proj_u", "strip_w", "strip_b", "z", "frame_idx")


def _setup(h, w):
    jcfg = JConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640, gray_bits=5)
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640, gray_bits=5)
    jc = jcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    tc = tcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    frames, z_gt, pu_gt = jsynth.render_dynamic_sequence(
        jc, jcfg, 2, stripe_period=12, noise_sigma=1.0)
    jst = j_init(jnp.asarray(frames[0]), jnp.asarray(pu_gt[0], jnp.float32),
                 jnp.asarray(z_gt[0], jnp.float32), jcfg, use_pallas=False)
    st = TrackerState.from_numpy({k: np.asarray(getattr(jst, k))
                                  for k in _STATE}, device="cpu")
    return (jcfg, cfg, jcalib.build_tables(jc, h, w),
            tcalib.build_tables(tc, h, w, device="cpu"), frames, jst,
            st)


def _copy(jst):
    """A copy of a JAX state: slc_tpu's dynamic_step donates its input."""
    return dataclasses.replace(
        jst, **{k: jnp.array(getattr(jst, k)) for k in _STATE})


def _scalars(jt, jcfg):
    return jnp.stack([jt.a, jt.b, jt.fx, jt.fy, jt.cx, jt.cy,
                      jnp.float32(jcfg.fov_min),
                      jnp.float32(jcfg.fov_max)]).reshape(1, 8)


def _check(got_state, got, want, bars):
    """``want`` = (pu, sw, sb, z, x, y) numpy; bars = (pu, strips, z, x)."""
    pu, sw, sb, z, x, y = (np.asarray(a) for a in want)
    b_pu, b_strip, b_z, b_x = bars
    np.testing.assert_allclose(got.proj_u.numpy(), pu, atol=b_pu)
    np.testing.assert_allclose(got_state.strip_w.numpy(), sw, atol=b_strip)
    np.testing.assert_allclose(got_state.strip_b.numpy(), sb, atol=b_strip)
    np.testing.assert_allclose(got.z.numpy(), z, atol=b_z)
    np.testing.assert_allclose(got.x.numpy(), x, atol=b_x)
    np.testing.assert_allclose(got.y.numpy(), y, atol=b_x)


def test_init_tracker_matches_jax():
    jcfg, cfg, _, _, frames, jst, st = _setup(96, 160)
    got = init_tracker(torch.from_numpy(frames[0]), st.proj_u, st.z, cfg)
    np.testing.assert_array_equal(got.strip_w.numpy(),
                                  np.asarray(jst.strip_w))
    np.testing.assert_array_equal(got.strip_b.numpy(),
                                  np.asarray(jst.strip_b))
    assert got.frame_idx == 0


@pytest.mark.parametrize("shape", [(96, 160), (90, 150)])
@pytest.mark.parametrize("win_u", [21, 13])
def test_locked_step_matches_jax(shape, win_u):
    jcfg, cfg, jt, tt, frames, jst, st = _setup(*shape)
    new, res = dynamic_step(st, torch.from_numpy(frames[1]), tt, cfg,
                            phase_lock=12.0, lock_win_u=win_u, lock_win_v=9)
    assert new.frame_idx == 1
    bars = (2e-3, 1e-5, 4e-3, 4e-3)

    js, jr = j_step(_copy(jst), jnp.asarray(frames[1]), jt, jcfg,
                    use_pallas=False, phase_lock=12.0, lock_win_u=win_u,
                    lock_win_v=9)
    _check(new, res, (jr.proj_u, js.strip_w, js.strip_b, jr.z, jr.x, jr.y),
           bars)

    # block_h=64: the kernel's gate bands are then GATE_BAND rows.
    want = dynamic_step_lock_pallas(
        jnp.asarray(frames[1]), jst.strip_w, jst.strip_b, jst.proj_u, jt.c,
        jt.d, _scalars(jt, jcfg), window=jcfg.reco_window,
        fov_min=jcfg.fov_min, fov_max=jcfg.fov_max, period=12.0,
        win_u=win_u, win_v=9, block_h=64, interpret=True)
    _check(new, res, want, bars)


@pytest.mark.parametrize("shape", [(96, 160), (90, 150)])
@pytest.mark.parametrize("reference_semantics", [False, True])
def test_open_loop_step_matches_jax(shape, reference_semantics):
    jcfg, cfg, jt, tt, frames, jst, st = _setup(*shape)
    flags = dict(scale_gradient=not reference_semantics,
                 subpixel=not reference_semantics,
                 robust=not reference_semantics)
    new, res = dynamic_step(st, torch.from_numpy(frames[1]), tt, cfg,
                            **flags)
    bars = (2e-4, 1e-5, 2e-3, 2e-4)

    js, jr = j_step(_copy(jst), jnp.asarray(frames[1]), jt, jcfg,
                    use_pallas=False, **flags)
    _check(new, res, (jr.proj_u, js.strip_w, js.strip_b, jr.z, jr.x, jr.y),
           bars)

    want = dynamic_step_pallas(
        jnp.asarray(frames[1]), jst.strip_w, jst.strip_b, jst.proj_u, jt.c,
        jt.d, _scalars(jt, jcfg), window=jcfg.reco_window, block_h=64,
        interpret=True, **flags)
    _check(new, res, want, bars)


def test_state_from_numpy_round_trip():
    _, _, _, _, _, jst, st = _setup(96, 160)
    back = st.to_numpy()
    for k in _STATE:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jst, k)))


def test_step_kernels_reject_fast_subpixel_and_cpu_tensors():
    """The step kernels reject a negative ``frac_bits``, an unknown
    ``ablate``, and CPU tensors in exact and fast sub-pixel mode."""
    from slc_tpu_torch.kernels.dynamic_step import (dynamic_step_lock_cuda,
                                                    dynamic_step_open_cuda)
    _, cfg, _, tt, frames, _, st = _setup(96, 160)
    args = (torch.from_numpy(frames[1]), st.strip_w, st.strip_b, st.proj_u,
            tt)
    for fn in (dynamic_step_open_cuda, dynamic_step_lock_cuda):
        with pytest.raises(ValueError, match="frac_bits"):
            fn(*args, frac_bits=-1)
        for frac_bits in (0, 7):
            with pytest.raises(ValueError, match="cuda"):
                fn(*args, frac_bits=frac_bits)
    with pytest.raises(ValueError, match="ablate"):
        dynamic_step_lock_cuda(*args, ablate="snap")


def test_run_sequence_matches_jax():
    """run_sequence (a loop here, lax.scan in slc_tpu) over three frames,
    lock on."""
    from slc_tpu.dynamic import run_sequence as j_run_sequence
    from slc_tpu_torch.dynamic import run_sequence
    h, w = 96, 160
    jcfg, cfg, jt, tt, _, _, _ = _setup(h, w)
    jc = jcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    frames, z_gt, pu_gt = jsynth.render_dynamic_sequence(
        jc, jcfg, 4, stripe_period=12, noise_sigma=1.0)
    jst = j_init(jnp.asarray(frames[0]), jnp.asarray(pu_gt[0], jnp.float32),
                 jnp.asarray(z_gt[0], jnp.float32), jcfg, use_pallas=False)
    st = TrackerState.from_numpy({k: np.asarray(getattr(jst, k))
                                  for k in _STATE}, device="cpu")
    kw = dict(phase_lock=12.0, lock_win_u=21, lock_win_v=9)
    jfin, jres = j_run_sequence(jst, jnp.asarray(frames[1:]), jt, jcfg, **kw)
    fin, res = run_sequence(st, torch.from_numpy(frames[1:]), tt, cfg, **kw)
    assert fin.frame_idx == int(jfin.frame_idx) == 3
    np.testing.assert_allclose(res.proj_u.numpy(), np.asarray(jres.proj_u),
                               atol=2e-3)
    np.testing.assert_allclose(res.z.numpy(), np.asarray(jres.z), atol=4e-3)
