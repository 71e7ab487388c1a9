"""slc_tpu_torch.devtime: device timing raises without a CUDA device (it
never falls back to a wall clock), a profiler that records no CUDA
kernel raises ProfilerUnavailable, the peak tables know the H100 by the
name nvidia-smi reports, and count_ops counts a call's arithmetic. The
timing itself runs on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import weakref

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
    assert devtime.F32_PEAK_TFLOPS["NVIDIA H100 80GB HBM3"] == 67.0


_X = torch.arange(12, dtype=torch.float32).reshape(3, 4)


@pytest.mark.parametrize("fn,ops", [
    # Pointwise: one per output element, in place too.
    (lambda: (_X + 1.0) * 2.0, 24),
    (lambda: torch.where(_X > 3.0, torch.sin(_X), _X), 36),
    (lambda: _X.clone().add_(1.0), 12),
    # Reductions and scans: one per input element.
    (lambda: _X.sum(), 12),
    (lambda: _X.amax(dim=1), 12),
    (lambda: torch.cumsum(_X, dim=1), 12),
    # Views, copies, conversions, creation and indexing: none.
    (lambda: _X.t().reshape(4, 3)[1:, :2].contiguous(), 0),
    (lambda: (_X.to(torch.uint8), torch.zeros(5), torch.cat([_X, _X]),
              torch.roll(_X, 1, 0)), 0),
])
def test_count_ops(fn, ops):
    assert devtime.count_ops(fn) == ops


def test_rotating_cycles_the_sets_and_frees_each_result_in_turn():
    """``rotating`` calls ``fn`` on the sets in turn; a set's previous
    result is released before the call that replaces it (so the caching
    allocator hands that call the same memory), and held until then."""
    class Out:
        pass

    refs, calls = [], []

    def fn(s):
        if len(refs) >= 2:
            assert refs[-2]() is None        # the slot's old result: freed
            assert refs[-1]() is not None    # the other slot's: held
        calls.append(s)
        out = Out()
        refs.append(weakref.ref(out))
        return out

    call = devtime.rotating(fn, ["a", "b"])
    for _ in range(5):
        call()
    assert calls == ["a", "b", "a", "b", "a"]
