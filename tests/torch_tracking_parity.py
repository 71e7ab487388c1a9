"""Step-by-step parity of the port's tracker with slc_tpu's over a
sequence (helpers of tests/test_torch_sequence_100.py and
tests/test_torch_demod_adversarial.py; numpy and the port only).

slc_tpu's trajectory gives the carried state before every frame: its P
and z, and the strips of the previous frame, which are that frame's own
stripe regression (computed bit for bit alike by both packages). The
port's step from that state is held against slc_tpu's step at ROADMAP's
per-step bars: open loop P 2e-4, z 2e-3; locked P 2e-3, z 4e-3, with a
pinned number of isolated arccos tie flips, each within T/2 (the
standing rule of chip_smoke.py: 32 per 1.31 MP step; scaled to 15,360
px and rounded up, 1), z compared off them."""

import numpy as np
import torch

from slc_tpu_torch.dynamic import TrackerState, dynamic_step
from slc_tpu_torch.kernels.stripe import stripe_regression

#: Per-step bars (P, z): open loop, locked, and the frame-0 decode.
OPEN_BARS, LOCK_BARS, DECODE_BARS = (2e-4, 2e-3), (2e-3, 4e-3), (2e-3, 8e-3)
LOCK_FLIPS_PER_STEP = 1


def assert_step(f, pu, z, want_pu, want_z, bars, flips=0, period=12.0):
    """One step's maps against slc_tpu's, ``flips`` isolated tie flips of
    P pinned (each within ``period`` / 2), z compared off them."""
    d = np.abs(pu - want_pu)
    over = d > bars[0]
    assert over.sum() <= flips, (f, int(over.sum()), float(d.max()))
    assert (d <= period / 2 + bars[0]).all(), (f, float(d.max()))
    assert not (over[:-1, :-1] & over[1:, :-1] & over[:-1, 1:]
                & over[1:, 1:]).any(), f
    dz = np.where(over, 0.0, np.abs(z - want_z))
    assert dz.max() <= bars[1], (f, float(dz.max()))


def assert_steps_match(frames, jpu, jz, tables, cfg, kw, skip=()):
    """Every step f of ``frames`` (numpy (F, H, W)) but those in ``skip``:
    the port's step from slc_tpu's state (``jpu``, ``jz``: its P and z of
    frames 0..F-1) against slc_tpu's P and z of frame f."""
    locked = kw.get("phase_lock") is not None
    bars = LOCK_BARS if locked else OPEN_BARS
    sub = kw.get("subpixel", True)
    t = torch.from_numpy(frames)
    for f in range(1, len(frames)):
        if f in skip:
            continue
        sw, sb = stripe_regression(t[f - 1], cfg.reco_window, sub)
        st = TrackerState(proj_u=torch.from_numpy(jpu[f - 1]), strip_w=sw,
                          strip_b=sb, z=torch.from_numpy(jz[f - 1]),
                          frame_idx=f - 1)
        _, res = dynamic_step(st, t[f], tables, cfg, **kw)
        assert_step(f, res.proj_u.numpy(), res.z.numpy(), jpu[f], jz[f],
                    bars, LOCK_FLIPS_PER_STEP if locked else 0,
                    kw.get("phase_lock") or 12.0)


def assert_open_trajectory_matches(jax_traj, port_traj):
    """Open loop: P[f] = P[f-1] + deltaP sums f steps' differences, so at
    frame f the trajectories lie within f times the per-step bars."""
    for f in range(1, len(jax_traj[0])):
        for got, want, bar in zip(port_traj, jax_traj, OPEN_BARS):
            err = float(np.abs(got[f] - want[f]).max())
            assert err <= f * bar, (f, err, f * bar)
