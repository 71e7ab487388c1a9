"""slc_tpu_torch.parallel.launch: the single-process path, global meshes
and the host batch feed (tests/test_launch.py's four cases, on a 4-rank
gloo cluster where slc_tpu uses 8 virtual devices), and
``entry.dryrun_multichip`` on 8 gloo ranks."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_tasks as tasks
from slc_tpu_torch.parallel import SCAN, TILE_X, TILE_Y, launch


@pytest.fixture(scope="module")
def cluster():
    with launch.LocalCluster(4, device="cpu", timeout_s=120) as c:
        yield c


def test_initialize_single_process():
    ctx = launch.initialize(device="cpu")
    assert ctx.process_count == 1
    assert ctx.process_index == 0
    assert ctx.is_coordinator
    assert ctx.backend is None and ctx.device == torch.device("cpu")
    assert not dist.is_initialized()
    # Idempotent.
    assert launch.initialize(device="cpu").process_count == 1
    assert launch.global_tile_mesh() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch.initialize()            # the card unless asked
    with pytest.raises(ValueError, match="coordinator"):
        launch.initialize(num_processes=2, device="cpu")


def test_global_tile_mesh_axes(cluster):
    for dims, n in cluster.run(tasks.global_mesh, 2):
        assert dims[SCAN] == 2
        assert dims[TILE_Y] * dims[TILE_X] == 2
        assert n == 4


@pytest.mark.parametrize("scan,tiles,spec", [
    (4, None, (SCAN,)),
    (2, (1, 2), (SCAN, TILE_Y, TILE_X)),
])
def test_shard_host_batch_roundtrip(cluster, scan, tiles, spec):
    data = np.arange(scan * 6 * 8, dtype=np.float32).reshape(scan, 6, 8)
    results = cluster.run(tasks.host_batch, data, scan, tiles, spec)
    slices = sorted({r[0] for r in results})
    assert slices == [(g, g + 1) for g in range(scan)]
    for _, shape, total, back in results:
        assert shape == ((1, 6, 8) if tiles is None else (1, 6, 4))
        np.testing.assert_allclose(total, data.sum())
        np.testing.assert_array_equal(back, data)
    one = launch.shard_host_batch(None, data, spec, device="cpu")
    np.testing.assert_array_equal(one.numpy(), data)


def test_local_scan_slice_divisibility(cluster):
    for msg in cluster.run(tasks.scan_slice_error, 4, 6):
        assert "not divisible" in msg
    assert launch.local_scan_slice(None, 6) == slice(0, 6)


def test_dryrun_multichip_cpu(capfd):
    from slc_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(8, device="cpu", timeout_s=120)
    assert out["mesh"] == {"scan": 2, "ty": 2, "tx": 2}
    assert out["fusion_parity_delta"] < 1e-4
    assert out["backend"] == "gloo"
    printed = capfd.readouterr().out
    assert printed.count("dryrun_multichip ok: mesh={'scan': 2, 'ty': 2, "
                         "'tx': 2}") == 1
