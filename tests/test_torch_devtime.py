"""slc_tpu_torch.devtime: device timing raises without a CUDA device (it
never falls back to a wall clock), a profiler that records no CUDA
kernel raises ProfilerUnavailable, and the HBM peak table knows the H100
by the name nvidia-smi reports. The timing itself runs on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import pytest
import torch

from slc_tpu_torch import devtime


def test_device_time_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for kw in ({}, {"match": "stripe_kernel"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            devtime.device_time_s(lambda: None, n=2, **kw)


@pytest.mark.parametrize("fn", [devtime.graph_time_s,
                                lambda f: devtime.profiler_sees_cuda()])
def test_graph_time_and_probe_raise_without_cuda(fn):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(lambda: None)


def test_profiler_without_records_raises(monkeypatch):
    """A profiler that records no CUDA kernel at all (CUPTI denied) is
    told apart from a name that matches none of the kernels it saw."""
    monkeypatch.setattr(devtime, "_kernel_times_s", lambda fn, n, w: {})
    with pytest.raises(devtime.ProfilerUnavailable):
        devtime.device_time_s(lambda: None, n=2, match="")
    monkeypatch.setattr(devtime, "_kernel_times_s",
                        lambda fn, n, w: {"stripe_kernel": 1e-5})
    with pytest.raises(RuntimeError, match="no CUDA kernel named"):
        devtime.device_time_s(lambda: None, n=2, match="snap")
    assert devtime.device_time_s(lambda: None, n=2, match="") == 1e-5


def test_hbm_peak_by_card_name():
    assert devtime.HBM_PEAK_GBPS["NVIDIA H100 80GB HBM3"] == 3350.0
