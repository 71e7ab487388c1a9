"""The replay runner cases of tests/test_runner.py that no other port
test covers, through slc_tpu_torch on the CPU against slc_tpu on the
same datasets: injected faults, determinism, the automatic phase lock,
a failing cloud writer, and the CLI's sphere dataset. Bars against
slc_tpu: frame records and fault frames identical, valid fractions
within 1e-3, depth maps within the locked step's z bar 4e-3, a run's
median depth error within the per-step z bar of its tracker (locked
4e-3, open loop 2e-3), the frame-0 decode's P 2e-3 and z 8e-3."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import synth as jsynth
from slc_tpu.__main__ import main as j_main
from slc_tpu.calib import build_tables as j_build_tables
from slc_tpu.calib import synthetic_calibration
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.io.dataset import write_replay_dataset
from slc_tpu.io.opencv_yaml import save_calibration
from slc_tpu.pipeline import decode_first_frame as j_decode
from slc_tpu.runner import run_replay as j_run

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch import synth
from slc_tpu_torch.__main__ import main
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.io import load_calibration
from slc_tpu_torch.io.dataset import load_manifest
from slc_tpu_torch.pipeline import decode_first_frame
from slc_tpu_torch.runner import run_replay

torch.set_num_threads(2)

_SHAPE = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
JCFG = JConfig(**_SHAPE)
CFG = SystemConfig(**_SHAPE)


def _make_dataset(root, n=4, dz=0.3, **fields):
    """tests/test_runner.py's dataset: a plane at z = 50 and ``n`` frames
    moving ``dz`` a frame."""
    calib = synthetic_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    scene = jsynth.render_static_scene(calib, JCFG,
                                       jsynth.plane_surface(50.0),
                                       noise_sigma=1.0)
    frames, zs, _ = jsynth.render_dynamic_sequence(
        calib, JCFG, n, z0=50.0, dz_per_frame=dz, stripe_period=12,
        noise_sigma=1.0)
    write_replay_dataset(root, scene.gray_images, scene.phase_images,
                         frames, config_fields=fields or None)
    save_calibration(os.path.join(root, "parameters.yml"), calib)
    return zs


def _both(root, out_root, **kw):
    """The two packages' run_replay on one dataset: (port's, slc_tpu's)
    reports and output directories."""
    calib = os.path.join(root, "parameters.yml")
    out_t, out_j = str(out_root / "torch"), str(out_root / "jax")
    return ((run_replay(root, calib, out_t, CFG, device="cpu", **kw), out_t),
            (j_run(root, calib, out_j, JCFG, **kw), out_j))


def _median_err(z, z_gt):
    r = CFG.reco_window // 2 + 2
    zi, gi = z[r:-r, r:-r], z_gt[r:-r, r:-r]
    v = zi > 0
    assert v.mean() > 0.9
    return float(np.median(np.abs(zi[v] - gi[v])))


def test_run_replay_survives_injected_faults(tmp_path):
    """Dropped frames are skipped with the tracker state carried; the run
    completes, the faults are recorded, and they fall on slc_tpu's
    frames (the same seeded injector)."""
    root = str(tmp_path / "ds")
    _make_dataset(root)
    (report, _), (j_report, _) = _both(root, tmp_path, fault_drop_prob=0.5,
                                       fault_seed=3)
    assert report.frames_done >= 1
    faults = [r for r in report.metrics.records if "fault" in r]
    assert faults, "expected at least one injected fault with p=0.5"
    assert all(0.0 <= r["valid_frac"] <= 1.0
               for r in report.metrics.records)
    assert report.frames_done == j_report.frames_done
    recs, j_recs = report.metrics.records, j_report.metrics.records
    assert [r["frame"] for r in recs] == [r["frame"] for r in j_recs]
    assert ([r["frame"] for r in faults]
            == [r["frame"] for r in j_recs if "fault" in r])
    for a, b in zip(recs, j_recs):
        assert abs(a["valid_frac"] - b["valid_frac"]) <= 1e-3


def test_pipeline_determinism():
    """Same inputs, bit-identical outputs, on a sphere; and slc_tpu's
    decode within the decode's bars."""
    calib = synthetic_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    scene = jsynth.render_static_scene(calib, JCFG, jsynth.sphere_surface(),
                                       noise_sigma=1.0)
    tc = tcalib.synthetic_calibration(cam_h=96, cam_w=160, pro_h=96,
                                      pro_w=640)
    tables = tcalib.build_tables(tc, 96, 160, device="cpu")
    g = torch.from_numpy(scene.gray_images)
    p = torch.from_numpy(scene.phase_images)
    r1 = decode_first_frame(g, p, tables, CFG)
    r2 = decode_first_frame(g, p, tables, CFG)
    for k in ("x", "y", "z", "proj_u"):
        assert torch.equal(getattr(r1, k), getattr(r2, k)), k
    want = j_decode(jnp.asarray(scene.gray_images),
                    jnp.asarray(scene.phase_images),
                    j_build_tables(calib, 96, 160), JCFG)
    np.testing.assert_allclose(r1.proj_u.numpy(), np.asarray(want.proj_u),
                               atol=2e-3)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(r1, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=8e-3)


def test_run_replay_auto_phase_lock(tmp_path):
    """--phase-lock auto with the manifest's stripe_period: the runner
    sizes the lock from the frame-0 decode and tracks 30 frames with a
    terminal error < 0.05 and < half the unlocked run's; each run's error
    within its tracker's per-step z bar of slc_tpu's."""
    root = str(tmp_path / "ds")
    zs = _make_dataset(root, n=30, stripe_period=12)
    errs = {}
    for name, lock, bar in (("locked", "auto", 4e-3), ("free", None, 2e-3)):
        (_, out), (_, j_out) = _both(root, tmp_path / name, phase_lock=lock,
                                     out_format="npz")
        got, want = (
            _median_err(np.load(os.path.join(o, "cFrame29.npz"))["z"],
                        zs[29]) for o in (out, j_out))
        assert abs(got - want) <= bar, (name, got, want)
        errs[name] = got
    assert errs["locked"] < 0.05, errs
    assert errs["locked"] < 0.5 * errs["free"], errs


def test_stream_writer_failure_fails_the_run(tmp_path, monkeypatch):
    """A failed asynchronous cloud write fails the run: the writer's
    close() raises and run_replay propagates it, as slc_tpu's does."""
    root = str(tmp_path / "ds")
    _make_dataset(root)
    from slc_tpu_torch import cloud as cloud_mod
    real = cloud_mod.write_xyz

    def boom(path, x, y, z, mask=None):
        if "cFrame" in os.path.basename(path):
            raise IOError("disk full (injected)")
        return real(path, x, y, z, mask)

    monkeypatch.setattr(cloud_mod, "write_xyz", boom)
    with pytest.raises(IOError, match="async cloud writes failed"):
        run_replay(root, os.path.join(root, "parameters.yml"),
                   str(tmp_path / "out"), CFG, stream=True, device="cpu")


def test_cli_sphere_dataset_tracks_true_geometry(tmp_path):
    """The synth CLI's default sphere scene moves as a whole: the tracked
    depth of the last frame matches the analytically moved sphere
    (median < 0.1), and slc_tpu's run on the same dataset within 4e-3."""
    root = str(tmp_path / "ds")
    n = 4
    assert main(["synth", root, "--frames", str(n), "--cam", "96x160",
                 "--pro", "96x640", "--gray-bits", "5",
                 "--scene", "sphere"]) == 0
    m = load_manifest(root)
    cfg = SystemConfig(cam_h=m["cam_h"], cam_w=m["cam_w"],
                       pro_h=m["pro_h"], pro_w=m["pro_w"],
                       gray_bits=m["gray_bits"])
    out = str(tmp_path / "out")
    report = run_replay(root, os.path.join(root, "parameters.yml"), out,
                        cfg, out_format="npz", device="cpu")
    assert report.frames_done == n - 1
    z = np.load(os.path.join(out, f"cFrame{n - 1}.npz"))["z"]
    calib = load_calibration(os.path.join(root, "parameters.yml"))
    dz = 0.08                       # the CLI's per-frame z step
    z_gt, _ = synth.surface_geometry(
        calib, cfg,
        lambda dx, dy: synth.sphere_surface()(dx, dy) + dz * (n - 1))
    r = cfg.reco_window // 2 + 2
    zi, gi = z[r:-r, r:-r], z_gt[r:-r, r:-r]
    v = zi > 0
    assert v.mean() > 0.9
    med = float(np.median(np.abs(zi[v] - gi[v])))
    assert med < 0.1, med
    j_out = str(tmp_path / "jax")
    assert j_main(["run", root, "--calib",
                   os.path.join(root, "parameters.yml"), "--out", j_out,
                   "--out-format", "npz"]) == 0
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(
            np.load(os.path.join(out, f"cFrame{n - 1}.npz"))[k],
            np.load(os.path.join(j_out, f"cFrame{n - 1}.npz"))[k],
            atol=4e-3)
    with open(os.path.join(j_out, "metrics.jsonl")) as f:
        assert sum("frame" in json.loads(line) for line in f) == n
