"""Fast sub-pixel mode (``frac_bits`` > 0, ``run --fast-subpixel``) in the
port's plain stripe and step paths, against slc_tpu's Pallas stripe,
open-loop and locked kernels at ``frac_bits=7`` in interpret mode
(slc_tpu's XLA path ignores ``frac_bits``, slc_tpu/dynamic.py:126-130).

Bars: the strips within one quantum (1/2^7 px; the Pallas kernels divide
by an approximate reciprocal, which moves a fraction across a
quantization boundary now and then) and every winner the exact one; P
within one quantum; z, x and y at the locked bar, 4e-3."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.io.dataset import write_replay_dataset
from slc_tpu.io.opencv_yaml import save_calibration
from slc_tpu.pallas.dynamic_lock import dynamic_step_lock_pallas
from slc_tpu.pallas.dynamic_step import dynamic_step_pallas
from slc_tpu.pallas.stripe import stripe_regression_pallas

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch.__main__ import main
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.dynamic import TrackerState, dynamic_step
from slc_tpu_torch.kernels import dynamic_step as kstep
from slc_tpu_torch.kernels import stripe as kstripe
from slc_tpu_torch.ops.stripe import box_sum_vertical, windowed_extrema

torch.set_num_threads(2)

SHAPES = [(96, 160), (90, 150)]
Q = 1.0 / 128                             # one quantum at frac_bits=7


def _winners(frame):
    """The exact integer offsets (bright, dark) of every pixel."""
    return windowed_extrema(box_sum_vertical(torch.from_numpy(frame), 21),
                            21, False)


def _check_strips(got, want, frame):
    """Within one quantum of the Pallas strips, and on the same winner:
    both offsets within half a pixel of the exact integer offset."""
    for g, e, idx in zip(got, want, _winners(frame)):
        g, e, idx = g.numpy(), np.asarray(e), idx.numpy()
        np.testing.assert_allclose(g, e, atol=Q + 1e-6)
        assert np.abs(g - idx).max() <= 0.5
        # Pallas's un-quantized centre-tie fraction comes through its
        # approximate reciprocal: up to ~2e-3 past +-0.5.
        assert np.abs(e - idx).max() <= 0.5 + 2e-3
        # A winner other than the centre reads a fraction on the grid.
        moved = idx != 0
        assert np.array_equal(g[moved] * 128, np.round(g[moved] * 128))


def _dynamic_frames(h, w):
    jcfg = JConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640, gray_bits=5)
    jc = jcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    frames, z_gt, pu_gt = jsynth.render_dynamic_sequence(
        jc, jcfg, 2, stripe_period=12, noise_sigma=1.0)
    return jcfg, jc, frames, z_gt, pu_gt


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("source", ["random", "rendered"])
def test_stripe_fast_matches_pallas(shape, source):
    if source == "random":
        frame = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    else:
        frame = _dynamic_frames(*shape)[2][1]
    got = kstripe.stripe_regression(torch.from_numpy(frame), 21, True,
                                    frac_bits=7)
    want = stripe_regression_pallas(jnp.asarray(frame), 21, True,
                                     block_h=32, frac_bits=7, interpret=True)
    _check_strips(got, want, frame)


def _step_setup(h, w):
    jcfg, jc, frames, z_gt, pu_gt = _dynamic_frames(h, w)
    st = TrackerState.from_numpy({
        "proj_u": pu_gt[0], "z": z_gt[0], "frame_idx": 0,
        **dict(zip(("strip_w", "strip_b"), (
            a.numpy() for a in kstripe.stripe_regression(
                torch.from_numpy(frames[0]), 21))))}, device="cpu")
    jt = jcalib.build_tables(jc, h, w)
    scal = jnp.stack([jt.a, jt.b, jt.fx, jt.fy, jt.cx, jt.cy,
                      jnp.float32(jcfg.fov_min),
                      jnp.float32(jcfg.fov_max)]).reshape(1, 8)
    jargs = (jnp.asarray(frames[1]), jnp.asarray(st.strip_w.numpy()),
             jnp.asarray(st.strip_b.numpy()), jnp.asarray(st.proj_u.numpy()),
             jt.c, jt.d, scal)
    tc = tcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=96, pro_w=640)
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640, gray_bits=5)
    return cfg, st, tcalib.build_tables(tc, h, w, device="cpu"), frames[1], jargs


def _check_step(new, res, want, frame):
    pu, sw, sb, z, x, y = (np.asarray(a) for a in want)
    _check_strips((new.strip_w, new.strip_b), (sw, sb), frame)
    np.testing.assert_allclose(res.proj_u.numpy(), pu, atol=Q)
    for g, e in ((res.z, z), (res.x, x), (res.y, y)):
        np.testing.assert_allclose(g.numpy(), e, atol=4e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_open_loop_step_fast_matches_pallas(shape):
    cfg, st, tt, frame, jargs = _step_setup(*shape)
    new, res = dynamic_step(st, torch.from_numpy(frame), tt, cfg,
                            frac_bits=7)
    want = dynamic_step_pallas(*jargs, window=21, block_h=64, frac_bits=7,
                               interpret=True)
    _check_step(new, res, want, frame)


@pytest.mark.parametrize("shape", SHAPES)
def test_locked_step_fast_matches_pallas(shape):
    cfg, st, tt, frame, jargs = _step_setup(*shape)
    new, res = dynamic_step(st, torch.from_numpy(frame), tt, cfg,
                            phase_lock=12.0, lock_win_u=21, lock_win_v=9,
                            frac_bits=7)
    want = dynamic_step_lock_pallas(
        *jargs, window=21, fov_min=cfg.fov_min, fov_max=cfg.fov_max,
        period=12.0, win_u=21, win_v=9, block_h=64, frac_bits=7,
        interpret=True)
    _check_step(new, res, want, frame)


@pytest.mark.parametrize("frac_bits,window,lanes,subpixel,want", [
    (7, 21, 1280, True, 7),           # the reference width: 13 + 11 + 7
    (7, 21, 1280 + 42, True, 7),      # the locked step's lanes
    (7, 21, 2040 + 42, True, 6),      # lanes past 2048: a 12-bit column
    (7, 63, 1280, True, 6),           # a 14-bit box sum
    (7, 21, 2 ** 16, True, 0),        # 2 spare bits < 4: exact
    (7, 21, 1280, False, 0),          # no fraction to quantize
    (0, 21, 1280, True, 0),
    (5, 21, 160, True, 5),
])
def test_fast_frac_bits(frac_bits, window, lanes, subpixel, want):
    """slc_tpu/pallas/mathx.py:296-315's field arithmetic."""
    assert kstripe.fast_frac_bits(frac_bits, window, lanes, subpixel) == want


def test_fast_mode_rejects_negative_bits_and_cpu_tensors():
    _, st, tt, frame, _ = _step_setup(96, 160)
    args = (torch.from_numpy(frame), st.strip_w, st.strip_b, st.proj_u, tt)
    with pytest.raises(ValueError, match="frac_bits"):
        kstep.dynamic_step_open(*args, frac_bits=-1)
    with pytest.raises(ValueError, match="cuda"):
        kstripe.stripe_regression_cuda(args[0], 21, frac_bits=7)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fast") / "ds")
    cfg = JConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
    calib = jcalib.synthetic_calibration(cam_h=96, cam_w=160, pro_h=96,
                                         pro_w=640)
    scene = jsynth.render_static_scene(calib, cfg, jsynth.plane_surface(50.0),
                                       noise_sigma=1.0)
    frames, zs, _ = jsynth.render_dynamic_sequence(
        calib, cfg, 8, z0=50.0, dz_per_frame=0.3, stripe_period=12,
        noise_sigma=1.0)
    write_replay_dataset(root, scene.gray_images, scene.phase_images,
                         frames, config_fields={"stripe_period": 12})
    save_calibration(os.path.join(root, "parameters.yml"), calib)
    return root, zs


def _cli(root, out, *flags):
    assert main(["run", root, "--calib", os.path.join(root, "parameters.yml"),
                 "--out", out, "--out-format", "npz", "--device", "cpu",
                 "--cam", "96x160", "--pro", "96x640", "--gray-bits", "5",
                 *flags]) == 0
    return np.load(os.path.join(out, "cFrame7.npz"))["z"]


def test_cli_fast_subpixel_on_cpu(tmp_path, dataset, capsys):
    """``run --fast-subpixel`` is accepted and changes the tracked depth
    by a fraction of the locked error; under --reference-semantics it is
    off (frac_bits 0), as in slc_tpu/__main__.py:405."""
    root, zs = dataset
    fast = _cli(root, str(tmp_path / "fast"), "--fast-subpixel")
    exact = _cli(root, str(tmp_path / "exact"))
    assert "done: frames=7" in capsys.readouterr().out
    assert not np.array_equal(fast, exact)
    inner = (slice(12, -12), slice(12, -12))
    ok = (fast[inner] > 0) & (exact[inner] > 0)
    assert ok.mean() > 0.9
    err = np.median(np.abs(fast[inner][ok] - zs[7][inner][ok]))
    assert err < 0.05
    assert np.median(np.abs(fast[inner][ok] - exact[inner][ok])) < 0.2 * err
    ref = ["--reference-semantics"]
    np.testing.assert_array_equal(
        _cli(root, str(tmp_path / "rf"), *ref, "--fast-subpixel"),
        _cli(root, str(tmp_path / "r"), *ref))
