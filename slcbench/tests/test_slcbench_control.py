"""The control: the reference computed in bfloat16 in the program's place
must come out not correct, and the program on the same seed correct.
On the CPU at test size; on the card at each cell's own size (run there
with ``python -m pytest slcbench/tests -q --noconftest -m cuda``). The
tracked cells hold the program, and the control, to the reference in
float64."""

import os

import pytest
import torch

import slcbench_small as small
from slcbench import compare, harness

CONTROL = torch.bfloat16


def _cell(root, d, name, seed, device):
    """Cell ``name`` of the BENCHMARK.json in ``root``, its files in
    ``d``."""
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    return harness.make_cell(bench, d, name, seed, device,
                             harness.Spans(False, lambda: None))


def _fails(numbers, cell):
    checked = harness.check_numbers(numbers, cell.checks)
    return not harness.is_correct(checked)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return small.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_control_fails_and_the_program_passes(tiny, cell):
    torch.set_num_threads(2)
    c = _cell(tiny, tiny, cell, 99, "cpu")
    drv = harness.make_driver(c, tiny)
    drv.prepare()
    assert _fails(drv.control(CONTROL), c)
    out = small.run(tiny, cell, seed=99, seconds=0.4)
    assert out["correct"] is True


@pytest.mark.parametrize("cell", ["tiny_gray.track", "tiny_het.track"])
def test_the_tracked_check_asks_the_reference_for_float64(tiny, cell,
                                                          monkeypatch):
    """Every reference track a tracked run's check and its control make is
    in float64, and a sound run reads under every limit."""
    torch.set_num_threads(2)
    asked = []
    real = compare.Reference.track

    def track(self, parts, frames, dt=torch.float32):
        asked.append(dt)
        return real(self, parts, frames, dt)
    monkeypatch.setattr(compare.Reference, "track", track)
    out = small.run(tiny, cell, seed=2700000102, seconds=0.4)
    assert asked and set(asked) == {torch.float64}
    assert out["correct"] is True, out["checks"]
    for k, c in out["checks"].items():
        assert c["value"] <= c["limit"], k
    asked.clear()
    c = _cell(tiny, tiny, cell, 99, "cpu")
    drv = harness.make_driver(c, tiny)
    drv.prepare()
    assert _fails(drv.control(CONTROL), c)
    assert set(asked) == {torch.float64, CONTROL}
    assert asked.count(torch.float64) == asked.count(CONTROL)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dynaframe_1024x1280.track100",
                                  "dynaframe_1024x1280.scan"])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (5, 6, 7):
        c = _cell(os.path.dirname(harness.HERE), harness.HERE, cell, seed,
                  "cuda")
        drv = harness.make_driver(c, harness.HERE)
        drv.prepare()
        assert _fails(drv.control(CONTROL), c), seed
