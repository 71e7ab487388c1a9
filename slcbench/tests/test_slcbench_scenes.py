"""The benchmark's scene generator against the port's ``synth`` on one
seed at the 96x160 test rig, without noise (the two draw noise from
different generators): the same images up to a last-bit rounding of the
trigonometry, and the same geometry. With noise, the same seed gives the
same images."""

import numpy as np
import torch

from slc_tpu_torch import calib as pcalib
from slc_tpu_torch import synth as psynth
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig

from slcbench import scenes

SYS = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5,
           phase_steps=4)
CFG = SystemConfig(**SYS)
#: Pixels whose u8 value may differ by one (a value at .5 after the
#: float64 trigonometry of numpy and of torch).
ROUNDING = 1e-3


def _ren(seed=7, noise=0.0):
    cal = scenes.synthetic_calibration(96, 160, 96, 640)
    return scenes.renderer({"system": SYS}, cal, "cpu", seed, noise)


def _close(got, want):
    d = np.abs(got.numpy().astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= ROUNDING


def _pc():
    return pcalib.synthetic_calibration(cam_h=96, cam_w=160, pro_h=96,
                                        pro_w=640)


def test_calibration_equals_the_ports():
    pc, cal = _pc(), scenes.synthetic_calibration(96, 160, 96, 640)
    for k in ("cam_k", "pro_k", "rot", "trans"):
        np.testing.assert_array_equal(getattr(pc, k).numpy(), cal[k])


def test_gray_phase_stack_matches_synth():
    ren = _ren()
    want = psynth.render_static_scene(_pc(), CFG,
                                      psynth.plane_surface(52.0, 0.05, -0.02))
    got = ren.gray_phase(scenes.plane(52.0, 0.05, -0.02))
    _close(got, np.concatenate([want.gray_images, want.phase_images]))
    z, pu = ren.geometry(scenes.plane(52.0, 0.05, -0.02))
    np.testing.assert_allclose(z.numpy(), want.z_gt, rtol=1e-12)
    np.testing.assert_allclose(pu.numpy(), want.proj_u, atol=1e-9)


def test_sphere_and_fringes_match_synth():
    het = HeterodyneConfig()
    want, _, _ = psynth.render_fringe_stack(
        _pc(), CFG, psynth.sphere_surface((1.0, -2.0, 60.0), 25.0, 75.0),
        het.periods(CFG.pro_w), het.phase_steps)
    got = _ren().fringes(scenes.sphere((1.0, -2.0, 60.0), 25.0, 75.0),
                         het.fringe_counts, het.phase_steps)
    _close(got, want)


def test_stripes_match_synth():
    want, _, _ = psynth.render_dynamic_sequence(_pc(), CFG, 5, z0=50.0,
                                                dz_per_frame=0.08,
                                                stripe_period=12)
    got = _ren().stripes([scenes.offset(scenes.plane(50.0), 0.08 * f)
                          for f in range(5)], 12.0)
    _close(got, want)


def test_noise_is_drawn_from_the_seed():
    a = _ren(11, 1.0).stripes([scenes.plane(50.0)], 12.0)
    b = _ren(11, 1.0).stripes([scenes.plane(50.0)], 12.0)
    c = _ren(12, 1.0).stripes([scenes.plane(50.0)], 12.0)
    clean = _ren(11, 0.0).stripes([scenes.plane(50.0)], 12.0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    resid = (a.float() - clean.float())
    assert 0.8 < float(resid.std()) < 1.2
