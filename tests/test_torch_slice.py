"""The whole slice: slc_tpu_torch.runner.run_replay on the CPU against
slc_tpu.runner.run_replay on one synth dataset, lock on and off, in the
gray, heterodyne and spatial modes, plus the CLIs, checkpoint/resume
across packages, and a run that proves the port never imports jax.
Bars: z, x, y 4e-3; valid_frac 1e-3. Spatial clouds are compared on the
interior [1:-1, 1:-1]: the port's bilateral filter takes out-of-image
neighbours as missing where slc_tpu's XLA path wraps around."""

import argparse
import filecmp
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from slc_tpu import synth as jsynth
from slc_tpu.__main__ import main as j_main
from slc_tpu.calib import synthetic_calibration
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.io.dataset import write_replay_dataset
from slc_tpu.io.opencv_yaml import save_calibration
from slc_tpu.runner import run_replay as j_run

from slc_tpu_torch.__main__ import main
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.runner import run_replay

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHAPE = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
JCFG = JConfig(**_SHAPE)
CFG = SystemConfig(**_SHAPE)
N_FRAMES = 8
_CFG_FLAGS = ["--cam", "96x160", "--pro", "96x640", "--gray-bits", "5"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice") / "ds")
    calib = synthetic_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    scene = jsynth.render_static_scene(calib, JCFG,
                                       jsynth.plane_surface(50.0),
                                       noise_sigma=1.0)
    frames, _, _ = jsynth.render_dynamic_sequence(
        calib, JCFG, N_FRAMES, z0=50.0, dz_per_frame=0.3, stripe_period=12,
        noise_sigma=1.0)
    write_replay_dataset(root, scene.gray_images, scene.phase_images,
                         frames, config_fields={"stripe_period": 12})
    save_calibration(os.path.join(root, "parameters.yml"), calib)
    return root


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def fringe_dataset(tmp_path_factory):
    """What ``synth --fringes`` writes: a sphere over a plane, moving
    0.08 per frame, with the gray, phase and fringe stacks of frame 0."""
    root = str(tmp_path_factory.mktemp("fringes") / "ds")
    assert main(["synth", root, "--fringes", "--frames", str(N_FRAMES),
                 *_CFG_FLAGS]) == 0
    return root


def _run_both(dataset, out_root, clouds=True, **kw):
    """Run slc_tpu and the port (CPU) on one dataset with the same
    arguments and compare every frame record, the period diagnostic and,
    with ``clouds``, every cloud (on the interior in spatial mode).
    Returns the port's frame records, the cloud count and the diagnostic
    count."""
    calib = os.path.join(dataset, "parameters.yml")
    outs, done = {}, {}
    for name, fn, cfg, extra in (("jax", j_run, JCFG, {}),
                                 ("torch", run_replay, CFG,
                                  {"device": "cpu"})):
        outs[name] = str(out_root / name)
        done[name] = fn(dataset, calib, outs[name], cfg, out_format="npz",
                        **kw, **extra).frames_done
    assert done["torch"] == done["jax"]
    files = sorted(f for f in os.listdir(outs["jax"]) if f.endswith(".npz"))
    assert files == sorted(f for f in os.listdir(outs["torch"])
                           if f.endswith(".npz"))
    inner = ((slice(1, -1), slice(1, -1)) if kw.get("mode") == "spatial"
             else (slice(None), slice(None)))
    for f in files if clouds else ():
        want = np.load(os.path.join(outs["jax"], f))
        got = np.load(os.path.join(outs["torch"], f))
        for k in ("z", "x", "y"):
            np.testing.assert_allclose(got[k][inner], want[k][inner],
                                       atol=4e-3, err_msg=f"{f}:{k}")
    mj, mt = _metrics(outs["jax"]), _metrics(outs["torch"])
    fj = [r for r in mj if "frame" in r]
    ft = [r for r in mt if "frame" in r]
    assert [r["frame"] for r in ft] == [r["frame"] for r in fj]
    for a, b in zip(ft, fj):
        assert abs(a["valid_frac"] - b["valid_frac"]) <= 1e-3
        assert a.get("fault") == b.get("fault")
        assert a.get("reanchor") == b.get("reanchor")
    dj = [r for r in mj if r.get("period_diag")]
    dt = [r for r in mt if r.get("period_diag")]
    assert len(dt) == len(dj)
    for a, b in zip(dt, dj):
        assert a["period_nominal"] == b["period_nominal"]
        assert a["period_adopted"] == b["period_adopted"]
        assert abs(a["period_estimated"] / b["period_estimated"]
                   - 1.0) < 1e-4
    return ft, len(files), len(dt)


@pytest.mark.parametrize("lock", ["auto", None])
def test_run_replay_matches_jax(dataset, tmp_path, lock):
    frames, n_clouds, n_diag = _run_both(dataset, tmp_path, phase_lock=lock)
    assert n_clouds == N_FRAMES and len(frames) == N_FRAMES
    assert n_diag == (1 if lock else 0)


@pytest.mark.parametrize("variant", [
    {"fault_drop_prob": 0.5, "fault_seed": 3},
    {"stream": False},
    {"fault_corrupt_prob": 0.3, "fault_seed": 1, "clouds": False},
    {"refine_period": True, "checkpoint_every": 3, "clouds": False},
], ids=["drop", "strict", "corrupt", "refine"])
def test_run_replay_variants_match_jax(dataset, tmp_path, variant):
    """Fault records (the same injected faults on the same frames), the
    strict loop and the period refinement behave as in slc_tpu. After a
    noise frame, or with a period adopted from an estimate that differs
    in its last digits, single pixels part by more than the main path's
    bar, so those two compare the records only."""
    frames, _, _ = _run_both(dataset, tmp_path, **variant)
    faults = [r for r in frames if "fault" in r]
    if "fault_drop_prob" in variant:
        assert faults, "expected dropped frames with p=0.5"


@pytest.mark.parametrize("mode", ["heterodyne", "spatial"])
def test_run_replay_modes_match_jax(fringe_dataset, tmp_path, mode):
    """The heterodyne and spatial frame-0 decodes, then locked tracking,
    as in slc_tpu."""
    frames, n_clouds, n_diag = _run_both(fringe_dataset, tmp_path, mode=mode)
    assert n_clouds == N_FRAMES and len(frames) == N_FRAMES and n_diag == 1
    assert frames[0]["valid_frac"] > 0.9


def test_spatial_reanchor_keeps_fringe_order(tmp_path):
    """tests/test_runner.py:233-275 on the port: the spatial re-anchor is
    pinned to the tracker's absolute map, so frames 3 -> 4 -> 5 move by
    about dz, not by a fringe period, and slc_tpu writes the same
    clouds."""
    from slc_tpu.io.dataset import write_anchor_group
    root = str(tmp_path / "ds")
    calib = synthetic_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    z0, dz = 50.0, 0.3
    scene = jsynth.render_static_scene(calib, JCFG, jsynth.plane_surface(z0),
                                       noise_sigma=1.0)
    frames, _, _ = jsynth.render_dynamic_sequence(
        calib, JCFG, 6, z0=z0, dz_per_frame=dz, stripe_period=12,
        noise_sigma=1.0)
    write_replay_dataset(root, scene.gray_images, scene.phase_images,
                         frames)
    asc = jsynth.render_static_scene(calib, JCFG,
                                     jsynth.plane_surface(z0 + 4 * dz),
                                     noise_sigma=1.0, seed=5)
    write_anchor_group(root, 4, asc.gray_images, asc.phase_images)
    save_calibration(os.path.join(root, "parameters.yml"), calib)
    recs, _, _ = _run_both(root, tmp_path, mode="spatial")
    assert [r["frame"] for r in recs if r.get("reanchor")] == [4]
    med = {}
    for f in (3, 4, 5):
        z = np.load(str(tmp_path / "torch" / f"cFrame{f}.npz"))["z"]
        med[f] = np.median(z[z > 0])
    assert abs(med[4] - med[3]) < 5 * dz, med
    assert abs(med[5] - med[4]) < 5 * dz, med


def test_anchored_run_matches_jax(tmp_path):
    """A synth dataset with absolute anchor groups: the gray re-anchor
    path (decode kernel + stripe kernel on the card) as in slc_tpu."""
    ds = str(tmp_path / "ds")
    assert main(["synth", ds, "--frames", "7", "--anchor-every", "3",
                 *_CFG_FLAGS]) == 0
    frames, _, _ = _run_both(ds, tmp_path)
    assert [r["frame"] for r in frames if r.get("reanchor")] == [3, 6]


@pytest.mark.parametrize("extra", [["--anchor-every", "2"],
                                   ["--fringes", "--scene", "plane"]],
                         ids=["anchors", "fringes"])
def test_synth_clis_write_identical_datasets(tmp_path, extra):
    """A dataset either CLI writes is the other's, byte for byte."""
    args = ["--frames", "3", "--cam", "96x160", "--pro", "96x640",
            "--gray-bits", "5", *extra]
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert j_main(["synth", dj, *args]) == 0
    assert main(["synth", dt, *args]) == 0
    cmp = filecmp.dircmp(dj, dt)
    names = []

    def walk(c, prefix):
        assert not (c.left_only or c.right_only or c.funny_files), prefix
        _, mismatch, errors = filecmp.cmpfiles(c.left, c.right,
                                               c.common_files, shallow=False)
        assert not mismatch and not errors, (prefix, mismatch, errors)
        names.extend(c.common_files)
        for sub, sc in c.subdirs.items():
            walk(sc, f"{prefix}/{sub}")
    walk(cmp, "")
    assert "manifest.json" in names and "dynaCam2.bmp" in names
    if "--fringes" in extra:
        assert "vFringeCam11.bmp" in names


def test_cli_run_on_cpu(tmp_path, dataset, capsys):
    out = str(tmp_path / "o")
    assert main(["run", dataset, "--calib",
                 os.path.join(dataset, "parameters.yml"), "--out", out,
                 "--device", "cpu", "--strict-loop", *_CFG_FLAGS]) == 0
    assert "done: frames=7" in capsys.readouterr().out
    pts = np.loadtxt(os.path.join(out, "iFrame.txt"))
    assert (np.abs(pts[:, 2] - 50.0) < 1.0).mean() > 0.99
    assert os.path.exists(os.path.join(out, f"cFrame{N_FRAMES - 1}.txt"))


@pytest.mark.parametrize("mode", ["heterodyne", "spatial"])
def test_cli_runs_modes_on_cpu(tmp_path, fringe_dataset, mode, capsys):
    out = str(tmp_path / "o")
    assert main(["run", fringe_dataset, "--calib",
                 os.path.join(fringe_dataset, "parameters.yml"), "--out",
                 out, "--out-format", "npz", "--device", "cpu", "--mode",
                 mode, *_CFG_FLAGS]) == 0
    assert f"done: frames={N_FRAMES - 1}" in capsys.readouterr().out
    z = np.load(os.path.join(out, "iFrame.npz"))["z"]
    assert (z > 0).mean() > 0.9
    assert os.path.exists(os.path.join(out, f"cFrame{N_FRAMES - 1}.npz"))


class _Parsed(Exception):
    pass


def _cli_options(cli, monkeypatch):
    """{subcommand: its --options} of the parser that ``cli`` builds,
    taken from the parser itself when ``cli`` parses. (Not from --help:
    slc_tpu's ``run --help`` raises, its --refine-period help holding a
    bare "%".)"""
    def capture(self, *args, **kwargs):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as e:
        cli(["--help"])
    monkeypatch.undo()
    sub = next(a for a in e.value.args[0]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {o for a in p._actions for o in a.option_strings
                   if o.startswith("--") and o != "--help"}
            for name, p in sub.choices.items()}


@pytest.mark.parametrize("cmd", ["run", "synth", "capture", "fuse"])
def test_cli_surface_matches_slc_tpu(cmd, monkeypatch):
    """Every subcommand of slc_tpu but ``bench`` exists in the port with
    every one of its options; the port adds ``--device`` at most."""
    want = _cli_options(j_main, monkeypatch)
    got = _cli_options(main, monkeypatch)
    assert set(want) - {"bench"} == set(got)
    assert want[cmd] - got[cmd] == set(), f"{cmd}: options not ported"
    assert got[cmd] - want[cmd] <= {"--device"}, \
        f"{cmd}: options slc_tpu lacks"


def test_cli_run_chunk_on_cpu(tmp_path, dataset, capsys):
    out = str(tmp_path / "o")
    assert main(["run", dataset, "--calib",
                 os.path.join(dataset, "parameters.yml"), "--out", out,
                 "--device", "cpu", "--chunk", "3", "--out-format", "npz",
                 *_CFG_FLAGS]) == 0
    assert "done: frames=7" in capsys.readouterr().out
    recs = _metrics(out)
    assert any("t_dynamic_chunk_ms" in r for r in recs)
    assert os.path.exists(os.path.join(out, f"cFrame{N_FRAMES - 1}.npz"))


def test_device_cuda_without_cuda_raises(tmp_path, dataset):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_replay(dataset, os.path.join(dataset, "parameters.yml"),
                   str(tmp_path / "o"), CFG, device="cuda")


def test_resume_matches_uninterrupted(tmp_path, dataset):
    """Checkpoint mid-sequence + resume lands on the same terminal state
    as an uninterrupted run (test_runner.py:337-358)."""
    calib = os.path.join(dataset, "parameters.yml")
    full = run_replay(dataset, calib, str(tmp_path / "full"), CFG,
                      device="cpu", write_clouds=False)
    out = str(tmp_path / "resumed")
    run_replay(dataset, calib, out, CFG, device="cpu", write_clouds=False,
               checkpoint_every=2, max_frames=3)
    resumed = run_replay(dataset, calib, out, CFG, device="cpu",
                         write_clouds=False, checkpoint_every=2,
                         resume=True)
    a, b = full.metrics.records[-1], resumed.metrics.records[-1]
    assert resumed.frames_done == full.frames_done
    assert resumed.metrics.records[1]["frame"] == 3
    assert a["frame"] == b["frame"]
    assert abs(a["z_mean"] - b["z_mean"]) < 1e-5


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_checkpoint_resumes_across_packages(tmp_path, dataset,
                                                monkeypatch, writer):
    """An npz checkpoint one package wrote resumes in the other and lands
    where an uninterrupted run of the resuming package does. (slc_tpu
    writes npz when orbax is absent; the test takes that path.)"""
    import slc_tpu.checkpoint
    monkeypatch.setattr(slc_tpu.checkpoint, "_HAVE_ORBAX", False)
    calib = os.path.join(dataset, "parameters.yml")
    runs = {"jax": lambda out, **kw: j_run(dataset, calib, out, JCFG,
                                           write_clouds=False, **kw),
            "torch": lambda out, **kw: run_replay(dataset, calib, out, CFG,
                                                  device="cpu",
                                                  write_clouds=False, **kw)}
    reader = "torch" if writer == "jax" else "jax"
    full = runs[reader](str(tmp_path / "full")).metrics.records[-1]
    out = str(tmp_path / "crossed")
    runs[writer](out, checkpoint_every=2, max_frames=3)
    assert os.path.exists(os.path.join(out, "ckpt", "frame_2.npz"))
    crossed = runs[reader](out, resume=True).metrics.records
    assert crossed[1]["frame"] == 3
    assert crossed[-1]["frame"] == full["frame"] == N_FRAMES - 1
    assert abs(crossed[-1]["z_mean"] - full["z_mean"]) < 1e-4


def test_port_never_imports_jax(tmp_path):
    """With jax and slc_tpu made unimportable, synth --fringes -> run
    --save-depth --preview in every mode -> fuse, and capture -> run
    --chunk 2, still work end to end on the CPU."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["slc_tpu"] = None
        sys.path.insert(0, {_REPO!r})
        import torch
        torch.set_num_threads(2)
        from slc_tpu_torch.__main__ import main
        import slc_tpu_torch.devtime, slc_tpu_torch.kernels.floors
        import slc_tpu_torch.kernels.phaselock
        ds, out = {str(tmp_path / "ds")!r}, {str(tmp_path / "o")!r}
        assert main(["synth", ds, "--frames", "3", "--cam", "64x96",
                     "--pro", "64x640", "--gray-bits", "5",
                     "--fringes"]) == 0
        for mode in ("gray", "heterodyne", "spatial"):
            assert main(["run", ds, "--calib", ds + "/parameters.yml",
                         "--out", out + "/" + mode, "--out-format", "npz",
                         "--device", "cpu", "--mode", mode,
                         "--fast-subpixel", "--save-depth", "--preview"]) == 0
        assert main(["fuse", out + "/gray/depth_iFrame.npz",
                     out + "/spatial/depth_iFrame.npz", "--out",
                     out + "/fused", "--device", "cpu", "--rounds", "1"]) == 0
        cap = {str(tmp_path / "cap")!r}
        assert main(["capture", cap, "--scene", "plane", "--frames", "4",
                     "--cam", "64x96", "--pro", "64x640",
                     "--gray-bits", "5"]) == 0
        assert main(["run", cap, "--calib", cap + "/parameters.yml",
                     "--out", out + "/chunk", "--out-format", "npz",
                     "--device", "cpu", "--chunk", "2"]) == 0
        loaded = [m for m, mod in sys.modules.items() if mod is not None
                  and m.split(".")[0] in ("jax", "jaxlib", "slc_tpu")]
        assert not loaded, loaded
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
    for mode in ("gray", "heterodyne", "spatial"):
        z = np.load(tmp_path / "o" / mode / "cFrame2.npz")["z"]
        assert (z > 0).mean() > 0.9, mode
