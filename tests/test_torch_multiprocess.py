"""Real multi-process runs of slc_tpu_torch.parallel: 2 and 4 OS processes
join a gloo process group through launch's SLC_* environment contract,
feed their scan rows through ``shard_host_batch`` into
``tiled_batched_dynamic_step``, whose metrics cross the process boundary,
and match the port's single-device step (tests/torch_multiproc_worker.py
checks that in each process) and slc_tpu's (checked here, on the
coordinator's gathered maps). Also: a rank that raises, or outlasts the
timeout, ends its LocalCluster at once instead of hanging; and no module
of the port's parallel paths imports jax or slc_tpu."""

import json
import os
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.dynamic import dynamic_step as j_step
from slc_tpu.dynamic import init_tracker as j_init

import torch_parallel_tasks as tasks
from slc_tpu_torch.parallel.launch import LocalCluster

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_multiproc_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = JConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5,
               phase_steps=4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_cluster(tmp_path, n_procs: int, scan: int, timeout: int = 180):
    port = _free_port()
    procs, outs = [], []
    for rank in range(n_procs):
        out = tmp_path / f"rank{rank}.json"
        env = dict(os.environ, SLC_COORDINATOR=f"127.0.0.1:{port}",
                   SLC_NUM_PROCESSES=str(n_procs), SLC_PROCESS_ID=str(rank),
                   SLC_SCAN=str(scan), SLC_OUT=str(out), PYTHONPATH=_REPO)
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, out in enumerate(outs):
        assert out.exists(), f"rank {rank} wrote no result; log:\n{logs[rank]}"
        results.append(json.loads(out.read_text()))
    for rank, res in enumerate(results):
        assert res.get("ok"), (f"rank {rank} failed: "
                               f"{json.dumps(res, indent=1)}\n"
                               f"log:\n{logs[rank]}")
    return results, np.load(str(outs[0]) + ".npz")


@pytest.mark.parametrize("n_procs,scan", [(2, 2), (4, 2)])
def test_multiprocess_cluster(tmp_path, n_procs, scan):
    results, maps = _launch_cluster(tmp_path, n_procs, scan)
    tiles = n_procs // scan
    for rank, res in enumerate(results):
        assert res["process_index"] == rank
        assert res["process_count"] == n_procs
        assert res["backend"] == "gloo"
        assert res["mesh"]["scan"] == scan
        assert res["mesh"]["ty"] * res["mesh"]["tx"] == tiles
        assert res["frame_idx"] == 1
        assert res["foreign_modules"] == []
    # Every scan group owns a distinct contiguous block covering all.
    slices = sorted({tuple(r["local_scan_slice"]) for r in results})
    assert slices == [(g, g + 1) for g in range(scan)]

    # slc_tpu's single-device step on the same scans (the open-loop bars
    # of test_torch_dynamic.py: P 2e-4, z 2e-3).
    calib = jcalib.synthetic_calibration(cam_h=_CFG.cam_h, cam_w=_CFG.cam_w,
                                         pro_h=_CFG.pro_h, pro_w=_CFG.pro_w)
    tables = jcalib.build_tables(calib, _CFG.cam_h, _CFG.cam_w)
    for s in range(scan):
        frames, zs, pus = jsynth.render_dynamic_sequence(
            calib, _CFG, 2, z0=48.0 + 2.0 * s, dz_per_frame=0.5,
            stripe_period=12)
        st = j_init(jnp.asarray(frames[0]), jnp.asarray(pus[0], jnp.float32),
                    jnp.asarray(zs[0], jnp.float32), _CFG, use_pallas=False)
        _, want = j_step(st, jnp.asarray(frames[1]), tables, _CFG,
                         use_pallas=False)
        np.testing.assert_allclose(maps["proj_u"][s], np.asarray(want.proj_u),
                                   atol=2e-4)
        np.testing.assert_allclose(maps["z"][s], np.asarray(want.z),
                                   atol=2e-3)


def test_a_failing_rank_ends_the_cluster():
    """Rank 1 raises while the others wait for it in an all-reduce: the
    cluster reports rank 1's traceback and kills every rank well inside
    its 60 s timeout."""
    t0 = time.monotonic()
    cluster = LocalCluster(3, device="cpu", timeout_s=60)
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 failed.*fails on purpose"):
        cluster.run(tasks.fail_on, 1)
    assert time.monotonic() - t0 < 30
    with pytest.raises(RuntimeError, match="closed"):
        cluster.run(tasks.fail_on, 1)


def test_a_rank_past_the_timeout_ends_the_cluster():
    cluster = LocalCluster(2, device="cpu", timeout_s=60)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no result within 1 s"):
        cluster.run(time.sleep, 30, timeout_s=1)
    assert time.monotonic() - t0 < 15
    with pytest.raises(RuntimeError, match="closed"):
        cluster.run(time.sleep, 0)


def test_parallel_modules_import_neither_jax_nor_slc_tpu():
    code = ("import sys\n"
            "import slc_tpu_torch.parallel, slc_tpu_torch.parallel.launch\n"
            "import slc_tpu_torch.parallel.fusion_tiled\n"
            "import slc_tpu_torch.parallel.unwrap_tiled\n"
            "import slc_tpu_torch.entry, slc_tpu_torch.devtime\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'slc_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         env=dict(os.environ, PYTHONPATH=_REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
