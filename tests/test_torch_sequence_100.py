"""The reference's full 100-frame scenario (tests/test_sequence_100.py)
through slc_tpu_torch on the CPU, against slc_tpu on the same seeded
frames: reference semantics, the improved tracker, the phase-locked
tracker, and the improved tracker re-anchored every 25 frames.

Each case asserts slc_tpu's own drift bars on the port's trajectory, and
parity with slc_tpu at ROADMAP's bars:

- every step: the port's step from slc_tpu's carried state against
  slc_tpu's step (tests/torch_tracking_parity.py: open loop P 2e-4, z
  2e-3; locked P 2e-3, z 4e-3 with one isolated arccos tie flip pinned
  per step); re-anchor decodes at the decode's bars, P 2e-3 and z 8e-3.
- the whole trajectories, where a step's difference is carried into the
  next: in open loop P[f] = P[f-1] + deltaP sums f steps' differences,
  so at frame f P must lie within f x 2e-4 and z within f x 2e-3 of
  slc_tpu's (the per-step bars summed over f steps; measured: below f x
  7e-5 and f x 4e-5), counted from the last anchor, whose decode starts
  the decode bars apart. The locked tracker snaps P to the carrier every
  frame, so its error does not integrate, but a pinned tie flip moves
  the lock windows around its pixel on later frames: its trajectories
  are held by their drift, the median |z - z_gt| at frames 8 and 100,
  within the per-step z bar 4e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import synth as jsynth
from slc_tpu.calib import build_tables as j_build_tables
from slc_tpu.calib import synthetic_calibration as j_calibration
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.dynamic import init_tracker as j_init
from slc_tpu.dynamic import reanchor as j_reanchor
from slc_tpu.dynamic import run_sequence as j_run_sequence
from slc_tpu.pipeline import decode_first_frame as j_decode

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.dynamic import init_tracker, reanchor, run_sequence
from slc_tpu_torch.pipeline import decode_first_frame

from torch_tracking_parity import (DECODE_BARS, LOCK_BARS, OPEN_BARS,
                                   assert_open_trajectory_matches,
                                   assert_step, assert_steps_match)

torch.set_num_threads(2)

_SHAPE = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
JCFG = JConfig(**_SHAPE)
CFG = SystemConfig(**_SHAPE)
N_FRAMES = 100
Z0, DZ = 50.0, 0.08
T = 12.0
ANCHOR_EVERY = 25

VARIANTS = {
    "reference": dict(scale_gradient=False, subpixel=False, robust=False),
    "improved": {},
    "locked": dict(phase_lock=T, lock_win_u=21, lock_win_v=9),
    "anchored": {},
}


@pytest.fixture(scope="module")
def seq():
    """tests/test_sequence_100.py's sequence, both packages' tables."""
    jc = j_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    tc = tcalib.synthetic_calibration(cam_h=96, cam_w=160, pro_h=96,
                                      pro_w=640)
    frames, z_gt, pu_gt = jsynth.render_dynamic_sequence(
        jc, JCFG, N_FRAMES, z0=Z0, dz_per_frame=DZ, stripe_period=12,
        noise_sigma=1.0)
    return dict(calib=jc, jt=j_build_tables(jc, 96, 160),
                tt=tcalib.build_tables(tc, 96, 160, device="cpu"),
                frames=frames, z_gt=z_gt, pu_gt=pu_gt, runs={})


def _anchor_scene(seq, f):
    """The absolute pattern group projected at anchor frame ``f``."""
    return jsynth.render_static_scene(
        seq["calib"], JCFG, jsynth.plane_surface(Z0 + DZ * f),
        noise_sigma=1.0, seed=f)


def _segments():
    """(first, end) of each tracked run of frames, and the anchor frame
    after it (None for the last): test_sequence_100.py's loop."""
    out, f = [], 1
    while f < N_FRAMES:
        end = min(f + ANCHOR_EVERY - 1, N_FRAMES)
        out.append((f, end, end if end < N_FRAMES else None))
        f = end + 1
    return out


def _jax_run(seq, variant):
    """slc_tpu's trajectory: (P, z) of frames 0..99, frame 0 the truth,
    anchor frames their decode."""
    kw = VARIANTS[variant]
    sub = kw.get("subpixel", True)
    frames = jnp.asarray(seq["frames"])
    st = j_init(frames[0], jnp.asarray(seq["pu_gt"][0], jnp.float32),
                jnp.asarray(seq["z_gt"][0], jnp.float32), JCFG,
                subpixel=sub, use_pallas=False)
    pu = [seq["pu_gt"][0].astype(np.float32)]
    z = [seq["z_gt"][0].astype(np.float32)]
    spans = (_segments() if variant == "anchored"
             else [(1, N_FRAMES, None)])
    for first, end, anchor in spans:
        st, res = j_run_sequence(st, frames[first:end], seq["jt"], JCFG,
                                 **kw)
        pu.extend(np.asarray(res.proj_u))
        z.extend(np.asarray(res.z))
        if anchor is not None:
            asc = _anchor_scene(seq, anchor)
            dec = j_decode(jnp.asarray(asc.gray_images),
                           jnp.asarray(asc.phase_images), seq["jt"], JCFG)
            st = j_reanchor(st, frames[anchor], dec.proj_u, dec.z, JCFG,
                            use_pallas=False)
            pu.append(np.asarray(dec.proj_u))
            z.append(np.asarray(dec.z))
    return np.stack(pu), np.stack(z)


def _port_run(seq, variant):
    """The port's own trajectory, as :func:`_jax_run`."""
    kw = VARIANTS[variant]
    sub = kw.get("subpixel", True)
    frames = torch.from_numpy(seq["frames"])
    pu0 = torch.from_numpy(seq["pu_gt"][0].astype(np.float32))
    z0 = torch.from_numpy(seq["z_gt"][0].astype(np.float32))
    st = init_tracker(frames[0], pu0, z0, CFG, sub)
    pu, z = [pu0], [z0]
    spans = (_segments() if variant == "anchored"
             else [(1, N_FRAMES, None)])
    for first, end, anchor in spans:
        st, res = run_sequence(st, frames[first:end], seq["tt"], CFG, **kw)
        pu.extend(res.proj_u)
        z.extend(res.z)
        if anchor is not None:
            asc = _anchor_scene(seq, anchor)
            dec = decode_first_frame(torch.from_numpy(asc.gray_images),
                                     torch.from_numpy(asc.phase_images),
                                     seq["tt"], CFG)
            st = reanchor(st, frames[anchor], dec.proj_u, dec.z, CFG)
            pu.append(dec.proj_u)
            z.append(dec.z)
    return torch.stack(pu).numpy(), torch.stack(z).numpy()


def _runs(seq, variant):
    """Both packages' trajectories of ``variant``, computed once."""
    if variant not in seq["runs"]:
        seq["runs"][variant] = (_jax_run(seq, variant),
                                _port_run(seq, variant))
    return seq["runs"][variant]


def _drift(z, z_gt):
    """tests/test_sequence_100.py's median |z - z_gt| on the interior."""
    r = CFG.reco_window // 2 + 2
    z, gt = z[r:-r, r:-r], z_gt[r:-r, r:-r]
    valid = z > 0
    assert valid.mean() > 0.9
    return float(np.median(np.abs(z[valid] - gt[valid])))


def _drifts(seq, z):
    """Drift after 100 frames and after 8 (the 8th dynamic frame)."""
    return _drift(z[-1], seq["z_gt"][-1]), _drift(z[8], seq["z_gt"][8])


def _assert_steps_match(seq, variant, jax_traj):
    """Every step of the port from slc_tpu's carried state against
    slc_tpu's step; every anchor decode against slc_tpu's."""
    anchors = ({a for _, _, a in _segments()} - {None}
               if variant == "anchored" else set())
    for f in sorted(anchors):
        asc = _anchor_scene(seq, f)
        dec = decode_first_frame(torch.from_numpy(asc.gray_images),
                                 torch.from_numpy(asc.phase_images),
                                 seq["tt"], CFG)
        assert_step(f, dec.proj_u.numpy(), dec.z.numpy(), jax_traj[0][f],
                    jax_traj[1][f], DECODE_BARS)
    assert_steps_match(seq["frames"], *jax_traj, seq["tt"], CFG,
                       VARIANTS[variant], skip=anchors)


@pytest.mark.parametrize("variant", ["reference", "improved"])
def test_open_loop_steps_match_jax_over_100_frames(seq, variant):
    jax_traj, port_traj = _runs(seq, variant)
    _assert_steps_match(seq, variant, jax_traj)
    assert_open_trajectory_matches(jax_traj, port_traj)


def test_100_frame_drift_reference_vs_improved(seq):
    """tests/test_sequence_100.py's bars on the port's two open-loop
    trajectories: near-exact improved tracking over 8 frames, reference
    semantics drifting more, both finite over the full 100; both
    trajectories within the trajectory bars of slc_tpu's."""
    for variant in ("reference", "improved"):
        assert_open_trajectory_matches(*_runs(seq, variant))
    z_ref = _runs(seq, "reference")[1][1]
    z_imp = _runs(seq, "improved")[1][1]
    drift_ref, drift_ref8 = _drifts(seq, z_ref)
    drift_imp, drift_imp8 = _drifts(seq, z_imp)
    assert drift_imp8 < 0.02, drift_imp8
    assert drift_ref8 > 2.0 * drift_imp8, (drift_ref8, drift_imp8)
    assert drift_imp < 2.0, drift_imp
    assert drift_ref > 1.5 * drift_imp, (drift_ref, drift_imp)
    assert drift_ref < 6.0, drift_ref


def test_100_frame_phase_locked_tracking(seq):
    """The lock holds terminal drift at the per-frame noise level (< 0.1,
    < 0.1 x free-running, not integrating); every locked step matches
    slc_tpu's, and the drifts match slc_tpu's within 4e-3."""
    jax_traj, (_, z_lock) = _runs(seq, "locked")
    _assert_steps_match(seq, "locked", jax_traj)
    drift_locked, drift_locked_8 = _drifts(seq, z_lock)
    drift_free, _ = _drifts(seq, _runs(seq, "improved")[1][1])
    assert drift_locked < 0.1, drift_locked
    assert drift_locked < 0.1 * drift_free, (drift_locked, drift_free)
    assert drift_locked < 5.0 * max(drift_locked_8, 0.005), \
        (drift_locked, drift_locked_8)
    want, want_8 = _drifts(seq, jax_traj[1])
    assert abs(drift_locked - want) <= LOCK_BARS[1], (drift_locked, want)
    assert abs(drift_locked_8 - want_8) <= LOCK_BARS[1]


def test_100_frame_reanchoring_bounds_drift(seq):
    """Re-anchoring every 25 frames bounds the terminal drift (< 0.5 x
    free-running, < 0.25); every step and anchor decode matches
    slc_tpu's, and the trajectory within the open-loop trajectory bars
    counted from the last anchor."""
    jax_traj, port_traj = _runs(seq, "anchored")
    _assert_steps_match(seq, "anchored", jax_traj)
    last = 0
    anchors = {a for _, _, a in _segments()}
    for f in range(1, N_FRAMES):
        if f in anchors:
            last = f
            continue
        # After an anchor the carried maps start the decode bars apart.
        for got, want, bar, lead in zip(port_traj, jax_traj, OPEN_BARS,
                                        DECODE_BARS if last else (0, 0)):
            err = float(np.abs(got[f] - want[f]).max())
            assert err <= lead + (f - last) * bar, (f, err)
    drift_anchored = _drift(port_traj[1][-1], seq["z_gt"][-1])
    drift_free, _ = _drifts(seq, _runs(seq, "improved")[1][1])
    assert drift_anchored < 0.5 * drift_free, (drift_anchored, drift_free)
    assert drift_anchored < 0.25, drift_anchored
