"""slc_tpu_torch.capture and the port's ``capture`` CLI: the five cases
of tests/test_capture.py on the port, the rig's captures equal to
slc_tpu's, and both CLIs writing the same dataset byte for byte (BMPs,
manifest, parameters.yml)."""

import filecmp
import os

import numpy as np
import pytest
import torch

from slc_tpu import capture as jcapture
from slc_tpu.__main__ import main as j_main
from slc_tpu.calib import synthetic_calibration as j_calibration
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.synth import plane_surface as j_plane

from slc_tpu_torch import synth
from slc_tpu_torch.__main__ import main
from slc_tpu_torch.calib import build_tables, synthetic_calibration
from slc_tpu_torch.capture import (ReplaySensor, SimulatedRig,
                                   capture_sequence,
                                   structured_light_patterns)
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.pipeline import decode_first_frame
from slc_tpu_torch.runner import run_replay

torch.set_num_threads(2)

_SHAPE = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
CFG = SystemConfig(**_SHAPE)
_CFG_FLAGS = ["--cam", "96x160", "--pro", "96x640", "--gray-bits", "5"]


def test_capture_through_simulated_rig():
    calib = synthetic_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    tables = build_tables(calib, 96, 160, device="cpu")
    rig = SimulatedRig(calib, CFG, synth.plane_surface(50.0),
                       noise_sigma=1.0)
    imgs = capture_sequence(rig, structured_light_patterns(CFG))
    assert len(imgs) == 2 * CFG.gray_bits + CFG.phase_steps
    # The same captures as slc_tpu's rig (same seed, same model).
    jrig = jcapture.SimulatedRig(
        j_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640),
        JConfig(**_SHAPE), j_plane(50.0), noise_sigma=1.0)
    want = jcapture.capture_sequence(
        jrig, jcapture.structured_light_patterns(JConfig(**_SHAPE)))
    for a, b in zip(imgs, want):
        np.testing.assert_array_equal(a, b)

    gray = torch.from_numpy(np.stack(imgs[:2 * CFG.gray_bits]))
    phase = torch.from_numpy(np.stack(imgs[2 * CFG.gray_bits:]))
    z = decode_first_frame(gray, phase, tables, CFG).z.numpy()
    valid = z > 0
    assert valid.mean() > 0.95
    # Whole-column (DMD-style) pattern sampling: ~0.1 z units RMSE.
    assert np.sqrt(np.mean((z[valid] - 50.0) ** 2)) < 0.2


def test_replay_sensor_sequencing(rng):
    imgs = rng.integers(0, 256, (3, 8, 8), dtype=np.uint8)
    got = capture_sequence(ReplaySensor(imgs), [None, None, None])
    np.testing.assert_array_equal(np.stack(got), imgs)


def test_capture_cli_dataset_reconstructs(tmp_path):
    """``python -m slc_tpu_torch capture`` acquires a dataset that the
    port's ``run`` reconstructs accurately."""
    root = str(tmp_path / "cap")
    assert main(["capture", root, "--scene", "plane", "--frames", "3",
                 *_CFG_FLAGS]) == 0
    assert os.path.exists(os.path.join(root, "iFrame", "vGrayCam9.bmp"))
    assert os.path.exists(os.path.join(root, "cFrame", "dynaCam2.bmp"))
    out = str(tmp_path / "out")
    report = run_replay(root, os.path.join(root, "parameters.yml"), out, CFG,
                        device="cpu")
    assert report.frames_done == 2
    pts = np.loadtxt(os.path.join(out, "iFrame.txt"))
    assert (np.abs(pts[:, 2] - 50.0) < 1.0).mean() > 0.99


class _FlakySensor:
    """Fails the first ``fail_n`` captures after each project() with
    IOError (the reference camera's snapshot failure, CCamera.cpp:97-107)."""

    def __init__(self, img, fail_n):
        self.img = img
        self.fail_n = fail_n
        self.attempts = 0

    def project(self, pattern):
        self._left = self.fail_n

    def capture(self):
        self.attempts += 1
        if self._left > 0:
            self._left -= 1
            raise IOError("snapshot failed")
        return self.img


def test_capture_retries_then_succeeds():
    img = np.full((4, 4), 7, np.uint8)
    s = _FlakySensor(img, fail_n=3)
    got = capture_sequence(s, [None, None], retries=30)
    assert len(got) == 2
    np.testing.assert_array_equal(got[0], img)
    assert s.attempts == 8          # 3 failures + 1 success per pattern


def test_capture_retries_exhausted():
    s = _FlakySensor(np.zeros((4, 4), np.uint8), fail_n=99)
    with pytest.raises(IOError, match="after 5 tries"):
        capture_sequence(s, [None], retries=5)
    assert s.attempts == 5


@pytest.mark.parametrize("extra", [["--scene", "plane", "--frames", "3"],
                                   ["--frames", "2", "--noise", "2.0",
                                    "--stripe-period", "14"]])
def test_capture_clis_write_identical_datasets(tmp_path, extra):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert j_main(["capture", dj, *extra, *_CFG_FLAGS]) == 0
    assert main(["capture", dt, *extra, *_CFG_FLAGS]) == 0
    names = []

    def walk(c, prefix):
        assert not (c.left_only or c.right_only or c.funny_files), prefix
        _, mismatch, errors = filecmp.cmpfiles(c.left, c.right,
                                               c.common_files, shallow=False)
        assert not mismatch and not errors, (prefix, mismatch, errors)
        names.extend(c.common_files)
        for sub, sc in c.subdirs.items():
            walk(sc, f"{prefix}/{sub}")
    walk(filecmp.dircmp(dj, dt), "")
    assert {"manifest.json", "parameters.yml", "vGrayCam9.bmp",
            "dynaCam1.bmp"} <= set(names)
