"""The multi-scan user flow on the CPU: ``run --save-depth --preview`` on
each scan, then ``fuse`` over the scans, through slc_tpu_torch's runner
and CLI against slc_tpu's on the same files (tests/test_fuse_cli.py and
tests/test_runner.py:278-295 are the behaviours mirrored).

Bars: poses.json within 2e-3 of slc_tpu's CLI and fused.txt the same
number of lines; depth_iFrame.npz z within 8e-3 of slc_tpu's (the
frame-0 decode bar) and cam_k equal; frame 0's preview u8 within 1 of
slc_tpu's on at most 0.1% of the interior.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slc_tpu import se3 as jse3
from slc_tpu import synth as jsynth
from slc_tpu.__main__ import main as j_main
from slc_tpu.calib import synthetic_calibration
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.runner import run_replay as j_run

from slc_tpu_torch import cloud, visualization
from slc_tpu_torch.__main__ import main
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.io.bmp import read_bmp
from slc_tpu_torch.runner import run_replay

torch.set_num_threads(2)

_SHAPE = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
JCFG = JConfig(**_SHAPE)
CFG = SystemConfig(**_SHAPE)
N_FRAMES = 4
_CFG_FLAGS = ["--cam", "96x160", "--pro", "96x640", "--gray-bits", "5"]


def _save_scans(tmp_path, n=3):
    """tests/test_fuse_cli.py:17-36: depth maps ray-cast from small known
    motions of the world scene (small enough that the CLI's identity
    initialization converges)."""
    calib = synthetic_calibration(cam_h=96, cam_w=128, cam_f=110.0)
    cam_k = np.asarray(calib.cam_k, np.float32)
    paths, trans_gt = [], []
    for i in range(n):
        r = np.asarray(jse3.exp_so3(jnp.asarray([0.0, 0.02 * i, 0.0],
                                                jnp.float32)), np.float64)
        t = np.array([0.5 * i, 0.05 * i, -0.1 * i])
        trans_gt.append(t)
        depth = jsynth.render_depth_from_pose(calib, 96, 128, r, t)
        p = str(tmp_path / f"scan{i}" / "depth_iFrame.npz")
        os.makedirs(os.path.dirname(p))
        np.savez(p, z=np.asarray(depth, np.float32), cam_k=cam_k)
        paths.append(p)
    return paths, np.stack(trans_gt)


def _poses(out):
    with open(os.path.join(out, "poses.json")) as f:
        return json.load(f)


def _lines(path):
    with open(path) as f:
        return sum(1 for _ in f)


def test_fuse_cli_matches_slc_tpu(tmp_path, capsys):
    paths, trans_gt = _save_scans(tmp_path)
    flags = ["--rounds", "6", "--grid-step", "6", "--max-depth-err", "2.0"]
    out, jout = str(tmp_path / "fused"), str(tmp_path / "jfused")
    assert main(["fuse", *paths, "--out", out, "--device", "cpu",
                 *flags]) == 0
    assert "fused 3 scans" in capsys.readouterr().out
    assert j_main(["fuse", *paths, "--out", jout, *flags]) == 0
    poses, jposes = _poses(out), _poses(jout)
    assert poses["scans"] == paths
    assert len(poses["world_from_scan"]) == 3
    for i, (p, q) in enumerate(zip(poses["world_from_scan"],
                                   jposes["world_from_scan"])):
        np.testing.assert_allclose(p["rot"], q["rot"], atol=2e-3)
        np.testing.assert_allclose(p["trans"], q["trans"], atol=2e-3)
        if i:
            # tests/test_fuse_cli.py:49-53: from the identity init the
            # relative translations approach ground truth.
            err = np.linalg.norm(np.asarray(p["trans"]) - trans_gt[i])
            assert err < 0.25 * np.linalg.norm(trans_gt[i]) + 0.05, (i, p)
    fused = np.loadtxt(os.path.join(out, "fused.txt"))
    assert fused.shape[1] == 3 and fused.shape[0] > 2 * 96 * 128
    assert fused.shape[0] == _lines(os.path.join(jout, "fused.txt"))


def _bad_inputs(tmp_path):
    paths, _ = _save_scans(tmp_path, n=2)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, foo=np.zeros(3))
    d = np.load(paths[1])
    other_k = str(tmp_path / "otherk.npz")
    np.savez(other_k, z=d["z"], cam_k=d["cam_k"] * 1.5)
    other_shape = str(tmp_path / "othershape.npz")
    np.savez(other_shape, z=d["z"][:-1], cam_k=d["cam_k"])
    return {"one_scan": [paths[0]], "not_a_depth_file": [paths[0], bad],
            "cam_k_mismatch": [paths[0], other_k],
            "shape_mismatch": [paths[0], other_shape]}


@pytest.mark.parametrize("case", ["one_scan", "not_a_depth_file",
                                  "cam_k_mismatch", "shape_mismatch"])
def test_fuse_cli_input_validation(tmp_path, case):
    """The inputs slc_tpu's fuse rejects, rejected the same way (with its
    messages) before any work on the device."""
    args = _bad_inputs(tmp_path)[case]
    msgs = []
    for fn, extra in ((main, ["--device", "cpu"]), (j_main, [])):
        with pytest.raises(SystemExit) as e:
            fn(["fuse", *args, "--out", str(tmp_path / "x"), *extra])
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1]
    assert not os.path.exists(tmp_path / "x")


def test_fuse_cli_device_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    paths, _ = _save_scans(tmp_path, n=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["fuse", *paths, "--out", str(tmp_path / "x")])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A sphere over the CLI's plane moving 0.08 per frame (what ``synth``
    writes), small."""
    root = str(tmp_path_factory.mktemp("scan") / "ds")
    assert main(["synth", root, "--frames", str(N_FRAMES), *_CFG_FLAGS]) == 0
    return root


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    """One ``run --save-depth --preview`` per package on the dataset."""
    root = tmp_path_factory.mktemp("runs")
    calib = os.path.join(dataset, "parameters.yml")
    out, jout = str(root / "torch"), str(root / "jax")
    assert main(["run", dataset, "--calib", calib, "--out", out,
                 "--out-format", "npz", "--device", "cpu", "--save-depth",
                 "--preview", *_CFG_FLAGS]) == 0
    assert j_main(["run", dataset, "--calib", calib, "--out", jout,
                   "--out-format", "npz", "--save-depth", "--preview",
                   *_CFG_FLAGS]) == 0
    return out, jout


def test_run_save_depth_matches_slc_tpu(runs):
    out, jout = runs
    d = np.load(os.path.join(out, "depth_iFrame.npz"))
    jd = np.load(os.path.join(jout, "depth_iFrame.npz"))
    assert sorted(d.files) == ["cam_k", "z"]
    assert d["z"].dtype == d["cam_k"].dtype == np.float32
    assert d["z"].shape == (CFG.cam_h, CFG.cam_w)
    assert d["cam_k"].shape == (3, 3)
    np.testing.assert_array_equal(d["cam_k"], jd["cam_k"])
    np.testing.assert_allclose(d["z"], jd["z"], rtol=0, atol=8e-3)
    # The depth is frame 0's, bit for bit.
    z0 = np.load(os.path.join(out, "iFrame.npz"))["z"]
    np.testing.assert_array_equal(d["z"].view(np.uint32), z0.view(np.uint32))
    assert (d["z"] > 0).mean() > 0.9


def test_run_preview_matches_slc_tpu(runs):
    """--preview writes shaded depth BMPs of frame 0 and of the final
    tracked frame, each the display of the render of that frame's depth;
    frame 0's within 1 of slc_tpu's on the interior. (The tracked depths
    of the two packages part by up to 4e-3, the step's bar, so their last
    previews are not compared.)"""
    out, jout = runs
    k = np.load(os.path.join(out, "depth_iFrame.npz"))["cam_k"]
    for name, z in (("preview_iFrame.bmp", "iFrame.npz"),
                    (f"preview_cFrame{N_FRAMES - 1}.bmp",
                     f"cFrame{N_FRAMES - 1}.npz")):
        img = read_bmp(os.path.join(out, name))
        assert img.shape == (CFG.cam_h, CFG.cam_w) and img.dtype == np.uint8
        assert 0 < img[10:-10, 10:-10].mean() < 255
        z = torch.from_numpy(np.load(os.path.join(out, z))["z"])
        lum = cloud.render_depth_map(z, float(k[0, 0]), float(k[1, 1]),
                                     float(k[0, 2]), float(k[1, 2]))
        np.testing.assert_array_equal(img,
                                      visualization.to_display(lum.numpy()))
    img = read_bmp(os.path.join(out, "preview_iFrame.bmp"))
    jimg = read_bmp(os.path.join(jout, "preview_iFrame.bmp"))
    d = np.abs(img.astype(int) - jimg.astype(int))[1:-2, 1:-2]
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, d.max()


def test_run_then_fuse_cli_matches_slc_tpu(runs, dataset, tmp_path):
    """The slice as a whole: the depth files of ``run --save-depth``
    (two scans of the same rig: the runs of both packages) into ``fuse``,
    both packages, poses within 2e-3 and the same cloud size."""
    out, jout = runs
    paths = [os.path.join(o, "depth_iFrame.npz") for o in (out, jout)]
    flags = ["--rounds", "2", "--grid-step", "8"]
    fo, jfo = str(tmp_path / "f"), str(tmp_path / "jf")
    assert main(["fuse", *paths, "--out", fo, "--device", "cpu",
                 *flags]) == 0
    assert j_main(["fuse", *paths, "--out", jfo, *flags]) == 0
    for p, q in zip(_poses(fo)["world_from_scan"],
                    _poses(jfo)["world_from_scan"]):
        np.testing.assert_allclose(p["trans"], q["trans"], atol=2e-3)
        np.testing.assert_allclose(p["rot"], q["rot"], atol=2e-3)
        # Two decodes of one scene: the poses stay near the identity.
        np.testing.assert_allclose(p["rot"], np.eye(3), atol=1e-2)
    assert _lines(os.path.join(fo, "fused.txt")) == \
        _lines(os.path.join(jfo, "fused.txt"))


def test_run_replay_preview_skips_the_last_frame_without_steps(dataset,
                                                              tmp_path):
    """With no tracked frame (max_frames=1) only frame 0 is previewed, as
    in slc_tpu (runner.py:457)."""
    out = str(tmp_path / "o")
    run_replay(dataset, os.path.join(dataset, "parameters.yml"), out, CFG,
               device="cpu", max_frames=1, preview=True, write_clouds=False)
    jout = str(tmp_path / "j")
    j_run(dataset, os.path.join(dataset, "parameters.yml"), jout, JCFG,
          max_frames=1, preview=True, write_clouds=False)
    for o in (out, jout):
        assert sorted(f for f in os.listdir(o) if f.endswith(".bmp")) == \
            ["preview_iFrame.bmp"]
