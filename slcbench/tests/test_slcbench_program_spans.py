"""The per-layer metrics read from the program's own spans and counters
(sources ``program_span`` and ``program_counter``) in a traced run of the
small cells on the CPU: each is reported, above 0 where the CPU path
does the work and 0 where only the card does (the fetch's wait, the
kernels' preparation, the staging copy's start delay: on the CPU the
copy runs inside the put). A program without spans, or an untraced run,
gives none of them."""

import math
import sys
import types

import pytest

import slcbench_small as small
from slcbench import harness
import slc_tpu_torch.metrics as pmetrics

PROGRAM = ("program_span", "program_counter")
#: Work the CPU path does not do: nothing to wait for, no kernel to
#: prepare, a staging copy that starts at once.
ZERO_ON_CPU = {"stream.fetch_wait_ms", "stream.fetch_wait_ms.track",
               "track.step_prep_ms", "stage.fn_delay_ms"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return small.make(tmp_path_factory.mktemp("bench"))


def _program_metrics(d, cell):
    b = harness.load_json(d + "/BENCHMARK.json")
    return {m["name"] for m in harness.cell_metrics(b, cell, True)
            if m["source"] in PROGRAM}


@pytest.mark.parametrize("cell", ["tiny_gray.track", "tiny_gray.scan"])
def test_a_traced_run_reads_the_programs_spans(tiny, cell):
    pmetrics.reset()
    out = small.run(tiny, cell, seed=2**31 + 5, seconds=0.4, trace=True)
    want = _program_metrics(tiny, cell)
    assert want == ({"stream.put_host_ms", "stream.fetch_wait_ms.track",
                     "track.step_host_ms", "track.step_prep_ms",
                     "setup.lock_window_ms", "setup.period_ms",
                     "stage.fn_delay_ms", "stage.host_copy_ms"}
                    if "track" in cell else
                    {"stream.fetch_wait_ms", "decode.host_ms"})
    got = {k: v["value"] for k, v in out["metrics"].items() if k in want}
    assert set(got) == want
    for name, v in got.items():
        assert math.isfinite(v), name
        assert (v == 0.0) if name in ZERO_ON_CPU else (v > 0.0), (name, v)
    pmetrics.reset()


def test_a_program_without_spans_gives_none(tiny, monkeypatch):
    run = harness.Run(config={}, latencies_s=[], spans={}, trace=object(),
                      hbm_bytes_per_s=None)
    names = sorted(_program_metrics(tiny, "tiny_gray.track")
                   | _program_metrics(tiny, "tiny_gray.scan"))
    monkeypatch.setitem(sys.modules, "slc_tpu_torch.metrics",
                        types.ModuleType("slc_tpu_torch.metrics"))
    for name in names:
        assert harness.load_module(tiny, "metrics", name).read(run) is None
    monkeypatch.delitem(sys.modules, "slc_tpu_torch.metrics")
    for name in names:
        assert harness.load_module(tiny, "metrics", name).read(run) is None
