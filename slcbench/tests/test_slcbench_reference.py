"""The frozen reference against the port's plain versions on the CPU, at
the port's 96x160 test rig: tables, both decodes and 8 locked steps of
the tracker agree exactly (the same float32 operations in the same
order), and the reference's bfloat16 control parts from them."""

import pytest
import torch

from slc_tpu_torch import calib as pcalib
from slc_tpu_torch import synth as psynth
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.dynamic import dynamic_step, init_tracker
from slc_tpu_torch.ops.demod import suggest_lock_window
from slc_tpu_torch.pipeline import (decode_first_frame,
                                    decode_heterodyne_frame)

from slcbench import scenes
from slcbench.reference import plain

torch.set_num_threads(2)

SYS = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5,
           phase_steps=4, fov_min=10.0, fov_max=100.0, reco_window=21,
           max_frames=100)
CFG = SystemConfig(**SYS)
TRACK = dict(scale_gradient=True, subpixel=True, robust=True)


@pytest.fixture(scope="module")
def rig():
    pc = pcalib.synthetic_calibration(cam_h=96, cam_w=160, pro_h=96,
                                      pro_w=640)
    cal = scenes.synthetic_calibration(96, 160, 96, 640)
    return pc, pcalib.build_tables(pc, 96, 160, device="cpu"), \
        plain.build_tables(cal, 96, 160, "cpu")


def test_tables_equal_the_ports(rig):
    _, pt, rt = rig
    for k in ("a", "b", "c", "d"):
        assert torch.equal(getattr(pt, k), getattr(rt, k)), k


@pytest.mark.parametrize("surface", ["plane", "sphere"])
def test_grayphase_decode_equals_the_ports(rig, surface):
    pc, pt, rt = rig
    surf = (psynth.plane_surface(52.0, 0.05, -0.03) if surface == "plane"
            else psynth.sphere_surface())
    sc = psynth.render_static_scene(pc, CFG, surf, noise_sigma=1.0, seed=3)
    g, p = torch.from_numpy(sc.gray_images), torch.from_numpy(sc.phase_images)
    want = decode_first_frame(g, p, pt, CFG)
    z, pu = plain.decode_grayphase(g, p, rt, SYS)
    assert torch.equal(pu, want.proj_u) and torch.equal(z, want.z)


@pytest.mark.parametrize("min_mod", [2.0, None])
def test_heterodyne_decode_equals_the_ports(rig, min_mod):
    pc, pt, rt = rig
    het = HeterodyneConfig()
    imgs, _, _ = psynth.render_fringe_stack(
        pc, CFG, psynth.plane_surface(55.0, 0.1, 0.05),
        het.periods(CFG.pro_w), het.phase_steps, noise_sigma=1.0)
    t = torch.from_numpy(imgs)
    want = decode_heterodyne_frame(t, pt, CFG, het, min_mod)
    z, pu = plain.decode_heterodyne(t, rt, SYS, het.fringe_counts,
                                    het.phase_steps, min_mod)
    assert torch.equal(pu, want.proj_u) and torch.equal(z, want.z)


def test_locked_tracker_equals_the_ports(rig):
    pc, pt, rt = rig
    sc = psynth.render_static_scene(pc, CFG, psynth.plane_surface(50.0),
                                    noise_sigma=1.0)
    frames, _, _ = psynth.render_dynamic_sequence(
        pc, CFG, 9, z0=50.0, dz_per_frame=0.08, stripe_period=12,
        noise_sigma=1.0)
    g, p = torch.from_numpy(sc.gray_images), torch.from_numpy(sc.phase_images)
    first = decode_first_frame(g, p, pt, CFG)
    win = suggest_lock_window(first.proj_u.numpy(), 12.0)
    st = init_tracker(torch.from_numpy(frames[0]), first.proj_u, first.z,
                      CFG)
    z0, pu0 = plain.decode_grayphase(g, p, rt, SYS)
    ref = plain.init_tracker(torch.from_numpy(frames[0]), pu0, SYS, TRACK,
                             12.0)
    assert ref.win_u == win
    assert torch.equal(ref.sw, st.strip_w) and torch.equal(ref.sb, st.strip_b)
    for f in range(1, len(frames)):
        fr = torch.from_numpy(frames[f])
        st, res = dynamic_step(st, fr, pt, CFG, phase_lock=12.0,
                               lock_win_u=win, lock_win_v=9)
        ref, z = plain.locked_step(ref, fr, rt, SYS, TRACK, 12.0, 9)
        assert torch.equal(ref.pu, st.proj_u), f
        assert torch.equal(z, res.z), f


def test_bfloat16_control_parts_from_float32(rig):
    pc, _, rt = rig
    sc = psynth.render_static_scene(pc, CFG, psynth.plane_surface(50.0),
                                    noise_sigma=1.0)
    g, p = torch.from_numpy(sc.gray_images), torch.from_numpy(sc.phase_images)
    z32, _ = plain.decode_grayphase(g, p, rt, SYS)
    z16, _ = plain.decode_grayphase(g, p, rt, SYS, torch.bfloat16)
    assert z16.dtype == torch.bfloat16
    assert float((z16.float() - z32).abs().median()) > 0.05
