"""The reader of ``unwrap.coarse_kernel_share``: the program's counter
``unwrap.coarse_kernel`` over ``unwrap.coarse_visits`` in a traced run,
and none where a counter, the program or the trace is missing."""

import sys
import types

import pytest

from slcbench import harness


@pytest.mark.parametrize("counts,want", [
    ({"unwrap.coarse_visits": 88, "unwrap.coarse_kernel": 88}, 1.0),
    ({"unwrap.coarse_visits": 88, "unwrap.coarse_kernel": 22}, 0.25),
    ({"unwrap.coarse_visits": 88, "unwrap.coarse_kernel": 0}, 0.0),
    ({"unwrap.coarse_visits": 0, "unwrap.coarse_kernel": 0}, None),
    ({"unwrap.coarse_visits": 88}, None),
    ({"unwrap.calls": 4, "unwrap.cg_iters": 18}, None)])
def test_the_coarse_kernel_share(monkeypatch, counts, want):
    """``unwrap.coarse_kernel`` over ``unwrap.coarse_visits`` in a traced
    run; none without a visit, without the kernel's counter (a program
    older than it), without the program or untraced."""
    reader = harness.load_module(harness.HERE, "metrics",
                                 "unwrap.coarse_kernel_share")
    run = harness.Run(config={}, latencies_s=[], spans={}, trace=object(),
                      hbm_bytes_per_s=None)
    fake = types.ModuleType("slc_tpu_torch.metrics")
    fake.counters = lambda: dict(counts)
    monkeypatch.setitem(sys.modules, "slc_tpu_torch.metrics", fake)
    assert reader.read(run) == want
    assert reader.read(harness.Run(config={}, latencies_s=[], spans={},
                                   trace=None, hbm_bytes_per_s=None)) is None
    monkeypatch.delitem(sys.modules, "slc_tpu_torch.metrics")
    assert reader.read(run) is None
