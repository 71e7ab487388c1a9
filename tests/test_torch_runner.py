"""The replay runner cases of tests/test_runner.py that no other port
test covers, through slc_tpu_torch on the CPU against slc_tpu on the
same datasets: injected faults, determinism, the automatic phase lock,
a failing cloud writer, and the CLI's sphere dataset. Bars against
slc_tpu: frame records and fault frames identical, valid fractions
within 1e-3, depth maps within the locked step's z bar 4e-3, a run's
median depth error within the per-step z bar of its tracker (locked
4e-3, open loop 2e-3), the frame-0 decode's P 2e-3 and z 8e-3.

The runner's public set-up (``decode_absolute``, ``lock_setup``,
``start_tracker``) is held bit-equal to the pipeline calls it wraps and
to what ``run_replay`` itself logs and tracks with on the same dataset."""

import json
import os
import shutil
import warnings

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
from slc_tpu_torch import runner as trunner
from slc_tpu_torch import synth
from slc_tpu_torch.__main__ import main
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.dynamic import init_tracker
from slc_tpu_torch.io import load_calibration
from slc_tpu_torch.io.dataset import (ReplayDataset, load_manifest,
                                      write_manifest)
from slc_tpu_torch.pipeline import (decode_first_frame,
                                    decode_heterodyne_frame,
                                    decode_spatial_frame)
from slc_tpu_torch.runner import (decode_absolute, lock_setup,
                                  pattern_group, run_replay, start_tracker,
                                  upload)

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


# --- the runner's public set-up -------------------------------------

_SYNTH = ["--cam", "96x160", "--pro", "96x640", "--gray-bits", "5"]
_MAPS = ("x", "y", "z", "proj_u")


@pytest.fixture(scope="module")
def seam_root(tmp_path_factory):
    """The CLI's sphere dataset with the fringe stack, 3 dynamic frames
    and the manifest's stripe period 12."""
    root = str(tmp_path_factory.mktemp("seam") / "ds")
    assert main(["synth", root, "--frames", "3", "--fringes"] + _SYNTH) == 0
    return root


def _seam_setup(root):
    ds = ReplayDataset(root, gray_count=2 * CFG.gray_bits,
                       phase_count=CFG.phase_steps)
    calib = load_calibration(os.path.join(root, "parameters.yml"))
    return ds, tcalib.build_tables(calib, CFG.cam_h, CFG.cam_w, "cpu")


@pytest.mark.parametrize("mode", ["gray", "heterodyne", "spatial",
                                  "spatial_anchored"])
def test_decode_absolute_is_the_pipeline_decode(seam_root, mode):
    """decode_absolute on pattern_group's uploaded images is bit-equal to
    the pipeline's own decode of the dataset's images, per mode; the
    spatial decode with and without an anchor map (the Gray decode's)."""
    ds, tables = _seam_setup(seam_root)
    het = HeterodyneConfig(phase_steps=CFG.phase_steps)
    gray, phase = torch.from_numpy(ds.gray_images()), \
        torch.from_numpy(ds.phase_images())
    anchor = None
    if mode == "gray":
        want = decode_first_frame(gray, phase, tables, CFG)
    elif mode == "heterodyne":
        want = decode_heterodyne_frame(
            torch.from_numpy(ds.fringe_images(het.num_images)), tables, CFG,
            het)
    else:
        if mode == "spatial_anchored":
            anchor = decode_first_frame(gray, phase, tables, CFG).proj_u
        want = decode_spatial_frame(phase, tables, CFG,
                                    float(CFG.phase_period), anchor=anchor)
    m = mode.split("_")[0]
    parts = [upload(a, "cpu") for a in pattern_group(ds, m, het)]
    got = decode_absolute(parts, m, tables, CFG, het, anchor=anchor)
    for k in _MAPS:
        assert torch.equal(getattr(got, k), getattr(want, k)), (mode, k)
    with pytest.raises(ValueError, match="unknown mode"):
        decode_absolute(parts, "phase", tables, CFG, het)


# (name, manifest's stripe_period as a multiple of the true 12 or None
# to drop it, the keywords given to run_replay and to lock_setup, the
# expected period: "nominal", "estimate", a float or None, the window:
# "suggested" or an int, and the expected warning)
_LOCK_CASES = [
    ("off", 1.0, dict(phase_lock=None), None, 9, None),
    ("auto", 1.0, dict(), "nominal", "suggested", None),
    ("auto_no_period", None, dict(), None, 9, None),
    ("forced", 1.0, dict(phase_lock=12.25), "nominal", "suggested",
     "deviates"),
    ("window", 1.0, dict(lock_window=15), "nominal", 15, None),
    ("refine_adopts", 1.05, dict(refine_period=True), "estimate",
     "suggested", "deviates"),
    ("refine_refuses", 1.15, dict(refine_period=True), "nominal",
     "suggested", "validity envelope"),
]


@pytest.mark.parametrize("case", _LOCK_CASES, ids=[c[0] for c in _LOCK_CASES])
def test_lock_setup_is_run_replays_lock(seam_root, tmp_path, monkeypatch,
                                        case):
    """lock_setup gives the period and window that run_replay tracks with
    and the period_diag summary it logs, with the same warnings (raised
    at run_replay's caller), for each way of setting the lock."""
    name, scale, kw, want_period, want_win, want_warn = case
    root = str(tmp_path / "ds")
    shutil.copytree(seam_root, root)
    man = load_manifest(root)
    if scale is None:
        del man["stripe_period"]
    else:
        man["stripe_period"] = 12.0 * scale
    write_manifest(root, man)

    seen = []
    real_step = trunner.dynamic_step

    def recording_step(*args, **kwargs):
        seen.append((kwargs["phase_lock"], kwargs["lock_win_u"]))
        return real_step(*args, **kwargs)

    monkeypatch.setattr(trunner, "dynamic_step", recording_step)
    with warnings.catch_warnings(record=True) as run_w:
        warnings.simplefilter("always")
        report = run_replay(root, os.path.join(root, "parameters.yml"),
                            str(tmp_path / "out"), CFG, device="cpu",
                            write_clouds=False, **kw)
    run_diag = [r for r in report.metrics.summaries if r.get("period_diag")]
    assert len(set(seen)) == 1 and len(seen) >= 2, seen

    ds, tables = _seam_setup(root)
    het = HeterodyneConfig(phase_steps=CFG.phase_steps)
    first = decode_absolute([upload(a, "cpu")
                             for a in pattern_group(ds, "gray", het)],
                            "gray", tables, CFG, het)
    with warnings.catch_warnings(record=True) as seam_w:
        warnings.simplefilter("always")
        lock = lock_setup(kw.get("phase_lock", "auto"), ds.manifest,
                          first.proj_u, ds.frame(0), kw.get("lock_window"),
                          kw.get("refine_period", False))

    assert (lock.period, lock.win_u) == seen[0], (lock, seen)
    assert ([lock.diag] if lock.diag else []) == run_diag
    assert ([(str(w.message), w.category) for w in seam_w]
            == [(str(w.message), w.category) for w in run_w])
    assert all(w.filename == __file__ for w in run_w), \
        [w.filename for w in run_w]
    if want_warn is None:
        assert not run_w, [str(w.message) for w in run_w]
    else:
        assert any(want_warn in str(w.message) for w in run_w), want_warn
    if want_period is None:
        assert lock.period is None and lock.diag is None
    elif want_period == "estimate":
        assert lock.period == pytest.approx(lock.diag["period_estimated"],
                                            abs=1e-5)
        assert lock.period != lock.diag["period_nominal"]
    else:
        assert lock.period == lock.diag["period_nominal"] \
            == float(kw.get("phase_lock", man.get("stripe_period")))
    if want_win == "suggested":
        want_win = trunner.suggest_lock_window(first.proj_u,
                                               lock.diag["period_nominal"])
    assert lock.win_u == want_win
    # A frame that cannot be read means no diagnostic, not a failure.
    if lock.diag is not None:
        def unreadable():
            raise IOError("unreadable")
        again = lock_setup(kw.get("phase_lock", "auto"), ds.manifest,
                           first.proj_u, unreadable, kw.get("lock_window"),
                           kw.get("refine_period", False))
        assert again.diag is None
        assert again.period == lock.diag["period_nominal"]
        assert again.win_u == lock.win_u


def test_start_tracker_retries_frame0(seam_root):
    """start_tracker is init_tracker on frame 0, read with up to 30
    attempts; 30 failed reads raise."""
    ds, tables = _seam_setup(seam_root)
    het = HeterodyneConfig(phase_steps=CFG.phase_steps)
    first = decode_absolute([upload(a, "cpu")
                             for a in pattern_group(ds, "gray", het)],
                            "gray", tables, CFG, het)
    want = init_tracker(torch.from_numpy(ds.frame(0)), first.proj_u,
                        first.z, CFG, True)

    class Flaky:
        def __init__(self, fails):
            self.fails = fails

        def frame(self, i):
            if self.fails:
                self.fails -= 1
                raise IOError("busy")
            return ds.frame(i)

    got = start_tracker(Flaky(29), first, CFG, True, "cpu")
    for k in ("proj_u", "strip_w", "strip_b", "z"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert got.frame_idx == want.frame_idx
    with pytest.raises(IOError, match="after 30 attempts"):
        start_tracker(Flaky(30), first, CFG, True, "cpu")
