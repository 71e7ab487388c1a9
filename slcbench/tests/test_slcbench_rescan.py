"""The spatial re-scan cell on the card at its own size: the control, the
reference computed in bfloat16 in the program's place, fails the check,
by ``rescan_off_share`` among its numbers (run with ``python -m pytest
slcbench/tests -q --noconftest -m cuda``). Its CPU cases at test size are
in ``tests/test_torch_spatial_rescan.py``."""

import os

import pytest
import torch

from slcbench import harness

CELL = "dynaframe_1024x1280_spatial.rescan100"


@pytest.mark.cuda
def test_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.load_json(os.path.join(os.path.dirname(harness.HERE),
                                           "BENCHMARK.json"))
    for seed in (5, 6, 7):
        c = harness.make_cell(bench, harness.HERE, CELL, seed, "cuda",
                              harness.Spans(False, lambda: None))
        drv = harness.make_driver(c, harness.HERE)
        drv.prepare()
        checked = harness.check_numbers(drv.control(torch.bfloat16),
                                        c.checks)
        assert not harness.is_correct(checked), (seed, checked)
        off = checked["rescan_off_share"]
        assert off["value"] > off["limit"], (seed, checked)
        del drv
