"""Dataset manifests (tests/test_manifest.py) through slc_tpu_torch on the
CPU: the port's ``synth`` writes slc_tpu's manifest, the port's readers
configure themselves from it (and from one slc_tpu wrote), a flag that
contradicts it fails clearly, and a dataset without one keeps the
reference's counts. The bare ``run`` is held against slc_tpu's on the
same dataset: the same frames, valid fractions within 1e-3."""

import json
import os

import numpy as np
import pytest
import torch

from slc_tpu.__main__ import main as j_cli
from slc_tpu.io.dataset import load_manifest as j_load_manifest

from slc_tpu_torch.__main__ import main as cli
from slc_tpu_torch.io.dataset import (MANIFEST_NAME, ReplayDataset,
                                      load_manifest, write_replay_dataset)

torch.set_num_threads(2)

CAM = "96x160"
PRO = "96x640"


def _synth(root, *extra, main=cli):
    assert main(["synth", root, "--cam", CAM, "--pro", PRO,
                 "--gray-bits", "5", "--frames", "2", *extra]) == 0


def test_synth_writes_manifest(tmp_path):
    root = str(tmp_path / "ds")
    _synth(root)
    m = load_manifest(root)
    assert m["gray_bits"] == 5
    assert m["gray_count"] == 10
    assert m["phase_count"] == 4
    assert m["frame_count"] == 2
    assert m["cam_h"] == 96 and m["cam_w"] == 160
    assert m["pro_w"] == 640
    j_root = str(tmp_path / "j")
    _synth(j_root, main=j_cli)
    assert m == j_load_manifest(j_root)


def test_replay_dataset_self_configures(tmp_path):
    """From the port's manifest and from slc_tpu's."""
    for name, main in (("ds", cli), ("j", j_cli)):
        root = str(tmp_path / name)
        _synth(root, main=main)
        ds = ReplayDataset(root)               # no explicit counts
        assert ds.gray_count == 10
        assert ds.phase_count == 4
        assert ds.frame_count == 2
        assert ds.gray_images().shape == (10, 96, 160)


def test_replay_dataset_conflict_raises(tmp_path):
    root = str(tmp_path / "ds")
    _synth(root)
    with pytest.raises(ValueError, match="manifest"):
        ReplayDataset(root, gray_count=12)


def _frames(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "frame" in r]


def test_cli_run_self_configures_from_manifest(tmp_path):
    """synth with non-default gray bits, then run with no flags but the
    device configures itself from the manifest, as slc_tpu's does."""
    root = str(tmp_path / "ds")
    _synth(root)
    outs = {}
    for name, main, extra in (("torch", cli, ["--device", "cpu"]),
                              ("jax", j_cli, [])):
        outs[name] = str(tmp_path / name)
        assert main(["run", root, "--calib",
                     os.path.join(root, "parameters.yml"), "--out",
                     outs[name], "--no-clouds", *extra]) == 0
    frames, want = _frames(outs["torch"]), _frames(outs["jax"])
    assert frames and all(r["valid_frac"] > 0.5 for r in frames)
    assert [r["frame"] for r in frames] == [r["frame"] for r in want]
    for a, b in zip(frames, want):
        assert abs(a["valid_frac"] - b["valid_frac"]) <= 1e-3


def test_cli_run_flag_conflict_fails_clearly(tmp_path):
    root = str(tmp_path / "ds")
    _synth(root)
    with pytest.raises(SystemExit, match="manifest"):
        cli(["run", root, "--calib", os.path.join(root, "parameters.yml"),
             "--out", str(tmp_path / "out"), "--gray-bits", "6",
             "--device", "cpu"])


def test_manifestless_dataset_uses_reference_defaults(tmp_path):
    """Datasets in the raw reference layout (no manifest) keep the
    reference's 12/4 counts (CSensorV.cpp:72,80)."""
    root = str(tmp_path / "raw")
    gray = np.zeros((12, 8, 16), np.uint8)
    phase = np.zeros((4, 8, 16), np.uint8)
    write_replay_dataset(root, gray, phase)
    os.remove(os.path.join(root, MANIFEST_NAME))
    ds = ReplayDataset(root)
    assert ds.gray_count == 12 and ds.phase_count == 4
