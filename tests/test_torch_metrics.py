"""Metrics (tests/test_metrics.py) through slc_tpu_torch on the CPU: stage
wall clocks land in the per-frame records, a stage without a log is
fine, the kernel wrappers reject phase-shift stacks of fewer than 3
steps before they ask for a card, and ``device_trace`` writes a profiler
trace. Frame stats are held against slc_tpu's on the same map (1e-6)."""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu.metrics import frame_stats as j_frame_stats

from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.metrics import MetricsLog, device_trace, frame_stats, stage

torch.set_num_threads(2)


def test_stage_records_wall_clock(tmp_path):
    log = MetricsLog()
    with stage("slc/dynamic_step", log):
        time.sleep(0.01)
    with stage("slc/write", log, bytes_moved=100_000_000):
        time.sleep(0.01)
    rec = log.log_frame(3, frame_stats(torch.ones((4, 4))))
    assert rec["t_dynamic_step_ms"] >= 10.0
    assert rec["t_write_ms"] >= 10.0
    assert rec["gbps_write"] > 0
    # Timings attach to exactly one frame.
    rec2 = log.log_frame(4, frame_stats(torch.ones((4, 4))))
    assert "t_dynamic_step_ms" not in rec2

    p = tmp_path / "metrics.jsonl"
    log.save(str(p))
    lines = [json.loads(line) for line in p.read_text().splitlines()]
    assert lines[0]["t_dynamic_step_ms"] >= 10.0

    z = np.random.default_rng(0).normal(50.0, 5.0, (24, 32))
    z[z < 48.0] = 0.0
    z = z.astype(np.float32)
    got = frame_stats(torch.from_numpy(z))
    want = j_frame_stats(jnp.asarray(z))
    assert set(got) == set(want)
    for k in got:
        assert abs(got[k] - float(want[k])) <= 1e-6 * max(1.0, abs(got[k]))


def test_stage_without_log_is_fine():
    with stage("slc/anonymous"):
        pass


def test_kernel_decoders_reject_degenerate_steps():
    """tests/test_metrics.py's test_pallas_decoders_reject_degenerate_steps
    for the port's wrappers: fewer than 3 phase steps raise ValueError
    naming n_steps before any CUDA requirement (so on the CPU too)."""
    from slc_tpu_torch.calib import build_tables, synthetic_calibration
    from slc_tpu_torch.kernels.grayphase import grayphase_decode_cuda
    from slc_tpu_torch.kernels.heterodyne import heterodyne_decode_cuda
    h, w = 8, 128
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=1280, gray_bits=6,
                       phase_steps=2)
    tables = build_tables(synthetic_calibration(cam_h=h, cam_w=w), h, w,
                          device="cpu")
    with pytest.raises(ValueError, match="n_steps"):
        grayphase_decode_cuda(torch.zeros((12, h, w), dtype=torch.uint8),
                              torch.zeros((2, h, w), dtype=torch.uint8),
                              tables, cfg)
    het = HeterodyneConfig(phase_steps=2)
    with pytest.raises(ValueError, match="n_steps"):
        heterodyne_decode_cuda(
            torch.zeros((het.num_images, h, w), dtype=torch.uint8), tables,
            cfg, het)


def test_device_trace_writes_a_trace(tmp_path):
    """On the CPU the trace holds the block's CPU activity, the stage
    annotations by name (the span ``slc.stage.<stage>``); on a CUDA
    device without a card it raises and writes nothing."""
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir, device="cpu"):
        with stage("slc/traced"):
            torch.ones((64, 64)).sum()
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "slc.stage.traced" in names
    if not torch.cuda.is_available():
        empty = str(tmp_path / "none")
        with pytest.raises(RuntimeError):
            with device_trace(empty):
                pass
        assert not os.path.exists(empty)
