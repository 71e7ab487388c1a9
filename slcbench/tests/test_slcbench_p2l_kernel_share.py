"""The reader of ``fusion.p2l_kernel_share``: the program's counter
``fusion.p2l_kernel`` over ``fusion.gn_steps`` in a traced run, and none
where a counter, the program or the trace is missing."""

import sys
import types

import pytest

from slcbench import harness


@pytest.mark.parametrize("counts,want", [
    ({"fusion.calls": 2, "fusion.gn_steps": 80, "fusion.p2l_kernel": 80},
     1.0),
    ({"fusion.gn_steps": 80, "fusion.p2l_kernel": 20}, 0.25),
    ({"fusion.gn_steps": 80, "fusion.p2l_kernel": 0}, 0.0),
    ({"fusion.gn_steps": 0, "fusion.p2l_kernel": 0}, None),
    ({"fusion.calls": 2, "fusion.gn_steps": 80}, None),
    ({"unwrap.calls": 4, "unwrap.cg_iters": 18}, None)])
def test_the_p2l_kernel_share(monkeypatch, counts, want):
    """``fusion.p2l_kernel`` over ``fusion.gn_steps`` in a traced run;
    none without a step, without the kernels' counter (a program older
    than it), without the program or untraced."""
    reader = harness.load_module(harness.HERE, "metrics",
                                 "fusion.p2l_kernel_share")
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
