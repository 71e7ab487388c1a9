"""Adversarial phase-lock scenes (tests/test_demod_adversarial.py)
through slc_tpu_torch on the CPU, against slc_tpu on the same seeded
frames: a non-sinusoidal carrier, a lock period off by +-2-5%, defocus
blur, extreme blur that must gate the lock off, ``estimate_period`` from
a wrong nominal, and the runner's period diagnostic.

Each case asserts slc_tpu's own bars on the port's result, and parity:
every locked and free step of the port from slc_tpu's carried state
against slc_tpu's step (tests/torch_tracking_parity.py: locked P 2e-3, z
4e-3 with one isolated tie flip pinned per step; open loop P 2e-4, z
2e-3), and each whole run's result, the median |z - z_gt| at its last
frame, within the per-step z bar of slc_tpu's. The maps of the whole
runs are not held pixel by pixel: under the extreme blur the free
tracker's gradient-scaled deltas amplify a last-bit difference of P
from frame to frame (1.4e-2 at one pixel after 14 steps, each step
within its bar; the medians equal). These scenes drive the lock's
amplitude gate and per-band carrier gate, whose per-band decisions
(``gates``) the plain step reports here and the kernel on the card
(tests/test_torch_cuda.py)."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import patterns as jpatterns
from slc_tpu import synth as jsynth
from slc_tpu.__main__ import main as j_main
from slc_tpu.calib import build_tables as j_build_tables
from slc_tpu.calib import synthetic_calibration as j_calibration
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.dynamic import init_tracker as j_init
from slc_tpu.dynamic import run_sequence as j_run_sequence
from slc_tpu.ops.demod import estimate_period as j_estimate_period
from slc_tpu.runner import run_replay as j_run

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.dynamic import init_tracker, run_sequence
from slc_tpu_torch.io.dataset import load_manifest, write_manifest
from slc_tpu_torch.kernels.dynamic_step import (dynamic_step_lock_ref,
                                                dynamic_step_open_ref)
from slc_tpu_torch.kernels.stripe import stripe_regression
from slc_tpu_torch.ops.demod import GATE_BAND, estimate_period
from slc_tpu_torch.runner import run_replay

from torch_tracking_parity import LOCK_BARS, OPEN_BARS, assert_steps_match

torch.set_num_threads(2)

T = 12          # projector-space stripe period (camera-space ~21 px)
N_FRAMES = 15
DZ = 0.15
_SHAPE = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
JCFG = JConfig(**_SHAPE)
CFG = SystemConfig(**_SHAPE)


@pytest.fixture(scope="module")
def rig():
    jc = j_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    tc = tcalib.synthetic_calibration(cam_h=96, cam_w=160, pro_h=96,
                                      pro_w=640)
    return jc, j_build_tables(jc, 96, 160), tcalib.build_tables(
        tc, 96, 160, device="cpu")


def _clean(pu):
    return jpatterns.stripe_at(pu, T)


def _nonsinusoidal(pu):
    """Clipped, odd-harmonic-rich carrier (40% third harmonic)."""
    phi = 2.0 * np.pi * pu / T
    raw = np.cos(phi) + 0.4 * np.cos(3 * phi)
    return np.clip((raw + 1.0) * 127.0, 0.0, 230.0)


def _render(calib, profile, blur_sigma=0.0, noise=1.0, seed=0):
    """tests/test_demod_adversarial.py's moving plane with a custom
    carrier ``profile(pu)`` and optional camera-side Gaussian blur."""
    rng = np.random.default_rng(seed)
    frames = np.empty((N_FRAMES, 96, 160), np.uint8)
    z_gt = np.empty((N_FRAMES, 96, 160))
    pu_gt = np.empty_like(z_gt)
    if blur_sigma > 0:
        rad = int(np.ceil(3 * blur_sigma))
        k = np.exp(-0.5 * (np.arange(-rad, rad + 1) / blur_sigma) ** 2)
        k /= k.sum()
    for f in range(N_FRAMES):
        z, pu = jsynth.surface_geometry(
            calib, JCFG, jsynth.plane_surface(50.0 + DZ * f))
        img = profile(pu)
        if blur_sigma > 0:
            img = np.apply_along_axis(
                lambda r: np.convolve(r, k, mode="same"), 1, img)
        img = img + rng.normal(0.0, noise, img.shape)
        frames[f] = np.clip(np.round(img), 0, 255).astype(np.uint8)
        z_gt[f], pu_gt[f] = z, pu
    return frames, z_gt, pu_gt


def _lock_kw(phase_lock):
    return (dict(phase_lock=phase_lock, lock_win_u=21, lock_win_v=9)
            if phase_lock is not None else {})


def _track_both(rig, frames, z_gt, pu_gt, phase_lock):
    """Both packages' runs from the true frame-0 maps; every step of the
    port held against slc_tpu's, and the runs' median errors. Returns the
    port's last depth map."""
    _, jt, tt = rig
    kw = _lock_kw(phase_lock)
    pu0, z0 = pu_gt[0].astype(np.float32), z_gt[0].astype(np.float32)
    jst = j_init(jnp.asarray(frames[0]), jnp.asarray(pu0), jnp.asarray(z0),
                 JCFG)
    _, jres = j_run_sequence(jst, jnp.asarray(frames[1:]), jt, JCFG, **kw)
    jax_traj = tuple(np.concatenate([m[None], np.asarray(r)])
                     for m, r in ((pu0, jres.proj_u), (z0, jres.z)))
    st = init_tracker(torch.from_numpy(frames[0]), torch.from_numpy(pu0),
                      torch.from_numpy(z0), CFG)
    _, res = run_sequence(st, torch.from_numpy(frames[1:]), tt, CFG, **kw)
    assert_steps_match(frames, *jax_traj, tt, CFG, kw)
    z_last = res.z[-1].numpy()
    bar = (LOCK_BARS if phase_lock is not None else OPEN_BARS)[1]
    assert abs(_median_err(z_last, z_gt[-1])
               - _median_err(jax_traj[1][-1], z_gt[-1])) <= bar
    return z_last


def _median_err(z_last, z_gt_last):
    r = CFG.reco_window // 2 + 2
    zi = z_last[r:-r, r:-r]
    gi = z_gt_last[r:-r, r:-r]
    v = zi > 0
    assert v.mean() > 0.85, "tracker lost most of the image"
    assert np.isfinite(zi).all()
    return float(np.median(np.abs(zi[v] - gi[v])))


def _locked_vs_free(rig, profile, blur_sigma=0.0, lock_period=float(T)):
    frames, z_gt, pu_gt = _render(rig[0], profile, blur_sigma=blur_sigma)
    locked = _median_err(_track_both(rig, frames, z_gt, pu_gt, lock_period),
                         z_gt[-1])
    free = _median_err(_track_both(rig, frames, z_gt, pu_gt, None),
                       z_gt[-1])
    return locked, free


def test_lock_clean_baseline(rig):
    locked, free = _locked_vs_free(rig, _clean)
    assert locked < 0.05, locked
    assert locked < free + 0.02, (locked, free)


def test_lock_nonsinusoidal_profile_degrades_gracefully(rig):
    locked, free = _locked_vs_free(rig, _nonsinusoidal)
    assert locked < max(1.5 * free, 0.08), (locked, free)


@pytest.mark.parametrize("mis", [1.05, 1.02, 0.98, 0.95])
def test_lock_period_mismatch_degrades_to_free_running(rig, mis):
    """The carrier gate zeroes the correction: locked == free within
    0.02 (slc_tpu's bar, one case per mismatch)."""
    locked, free = _locked_vs_free(rig, _clean, lock_period=float(T) * mis)
    assert abs(locked - free) < 0.02, (mis, locked, free)


def test_lock_defocus_blur_degrades_gracefully(rig):
    locked, free = _locked_vs_free(rig, _clean, blur_sigma=5.0)
    assert locked < max(1.5 * free, 0.15), (locked, free)


def test_lock_extreme_blur_gates_off(rig):
    """Near-total defocus: the amplitude gate zeroes the correction, so
    locked and free-running agree almost everywhere."""
    frames, z_gt, pu_gt = _render(rig[0], _clean, blur_sigma=12.0)
    z_lock = _track_both(rig, frames, z_gt, pu_gt, float(T))
    z_free = _track_both(rig, frames, z_gt, pu_gt, None)
    agree = np.isclose(z_lock, z_free, atol=1e-3).mean()
    assert agree > 0.9, agree


@pytest.mark.parametrize("profile, blur, period, gated", [
    (_clean, 0.0, T, 0), (_clean, 0.0, T * 1.05, 2), (_clean, 0.0, T * 0.95, 2),
    (_nonsinusoidal, 0.0, T, 0), (_clean, 12.0, T, 2)])
def test_plain_step_reports_its_carrier_gate(rig, profile, blur, period,
                                             gated):
    """``gates`` of the plain locked step: one decision per GATE_BAND-row
    band, 0 exactly where the step left the open-loop P unchanged on the
    whole band (a wrong period trips both bands of 96 rows, and so does
    the extreme blur's dead carrier)."""
    tt = rig[2]
    frames, _, pu_gt = _render(rig[0], profile, blur_sigma=blur)
    f0, f1 = (torch.from_numpy(f) for f in frames[:2])
    sw, sb = stripe_regression(f0, CFG.reco_window)
    pu = torch.from_numpy(pu_gt[0].astype(np.float32))
    kw = dict(window=CFG.reco_window, fov_min=CFG.fov_min,
              fov_max=CFG.fov_max)
    gates = torch.full((-(-96 // GATE_BAND),), -1.0)
    locked = dynamic_step_lock_ref(f1, sw, sb, pu, tt, period=float(period),
                                   win_u=21, win_v=9, gates=gates, **kw)
    free = dynamic_step_open_ref(f1, sw, sb, pu, tt, **kw)
    assert int((gates == 0).sum()) == gated, gates
    assert set(gates.tolist()) <= {0.0, 1.0}
    for b, g in enumerate(gates.tolist()):
        rows = slice(b * GATE_BAND, (b + 1) * GATE_BAND)
        if not g:
            assert torch.equal(locked[0][rows], free[0][rows])


def test_estimate_period_recovers_from_wrong_nominal(rig):
    """From a +-5-10% wrong nominal, one frame and the absolute map give
    the carrier period to 0.5% (slc_tpu's bar), and slc_tpu's estimate
    to 1e-4 relative (tests/test_torch_demod.py's bar)."""
    frames, _, pu_gt = _render(rig[0], _clean)
    pu0 = pu_gt[0].astype(np.float32)
    for nominal in (1.05, 0.95, 1.10, 0.90):
        t = float(estimate_period(torch.from_numpy(frames[0]),
                                  torch.from_numpy(pu0), float(T) * nominal,
                                  win_u=21, win_v=9))
        tj = float(j_estimate_period(jnp.asarray(frames[0]),
                                     jnp.asarray(pu0), float(T) * nominal,
                                     win_u=21, win_v=9))
        assert abs(t - T) / T < 0.005, (nominal, t)
        assert abs(t / tj - 1.0) < 1e-4, (nominal, t, tj)


def test_runner_period_diagnostic_and_refine(tmp_path):
    """A manifest period off by 5%: both runners warn, adopt the measured
    period (within 1% of the true one) and log the same diagnostic (the
    estimate within 1e-4 relative of slc_tpu's)."""
    root = str(tmp_path / "ds")
    assert j_main(["synth", root, "--frames", "3", "--cam", "96x160",
                   "--pro", "96x640", "--gray-bits", "5"]) == 0
    man = load_manifest(root)
    true_period = float(man["stripe_period"])
    man["stripe_period"] = true_period * 1.05
    write_manifest(root, man)
    calib = os.path.join(root, "parameters.yml")
    diags = {}
    for name, fn, cfg, extra in (("jax", j_run, JCFG, {}),
                                 ("torch", run_replay, CFG,
                                  {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as wlist:
            warnings.simplefilter("always")
            report = fn(root, calib, str(tmp_path / name), cfg,
                        write_clouds=False, refine_period=True, **extra)
        assert any("deviates" in str(w.message) for w in wlist), name
        diag = [r for r in report.metrics.summaries if r.get("period_diag")]
        assert len(diag) == 1, name
        diags[name] = diag[0]
        with open(os.path.join(tmp_path, name, "metrics.jsonl")) as f:
            assert sum(bool(json.loads(line).get("period_diag"))
                       for line in f) == 1
    d, dj = diags["torch"], diags["jax"]
    assert d["period_adopted"] is True
    assert d["period_deviation_pct"] > 1.0
    assert abs(d["period_estimated"] - true_period) / true_period < 0.01
    assert d["period_adopted"] == dj["period_adopted"]
    assert d["period_nominal"] == dj["period_nominal"]
    assert abs(d["period_estimated"] / dj["period_estimated"] - 1.0) < 1e-4
