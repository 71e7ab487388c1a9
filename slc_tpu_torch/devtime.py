"""Device-side kernel timing on a CUDA card (counterpart of
slc_tpu/devtime.py:28).

A host clock around a call measures its enqueue, or with a synchronize
its launch gaps too; what a roofline needs is the time the card spends.
``device_time_s`` takes it from CUDA events around each call, or, with
``match``, from the profiler's records of the kernels themselves, which
splits a call of several launches by kernel. ``graph_time_s`` takes the
kernels alone without the profiler: calls captured back to back in a
CUDA graph, its replays queued behind a spin kernel and timed by CUDA
events.

The profiler needs CUPTI tracing, which a process may be denied, and a
process's first profiling session may record no kernel while CUPTI
starts. ``profiler_sees_cuda`` probes for it; ``device_time_s(match=
...)`` raises :class:`ProfilerUnavailable` when a session records no
CUDA kernel at all. Without a CUDA device every timing function raises:
a device time never falls back to a wall clock.

``count_ops`` counts the arithmetic of a call from the operators it
dispatches, the operations side of a roofline bound; it runs anywhere.
``collective_bytes`` counts the bytes a rank exchanges in one call of a
tile-parallel function (slc_tpu/devtime.py:91 counts them from compiled
HLO, which torch has not); it runs anywhere too.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: Published device-memory bandwidth, GB/s, by the name ``nvidia-smi``
#: and ``torch.cuda.get_device_name`` report (NVIDIA's data sheets). A
#: card not listed has no "% of peak".
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}
#: Published float32 rate outside the tensor cores, TFLOP/s, by the same
#: names (NVIDIA's data sheets). A card not listed has no bound.
F32_PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 67.0}
#: Scans, which carry no reduction tag: one operation per input element.
_SCANS = ("cumsum", "cumprod", "cummax", "cummin", "logcumsumexp")


class ProfilerUnavailable(RuntimeError):
    """``torch.profiler`` recorded no CUDA kernel at all: CUPTI tracing
    is not available to this process."""


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device; none is "
                           "available")


def _warm(fn: Callable[[], object], warmup: int) -> None:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()


def _kernel_times_s(fn: Callable[[], object], n: int,
                    warmup: int) -> Dict[str, float]:
    """Mean device seconds per call of ``fn``, by CUDA kernel name, from
    ``torch.profiler`` over ``n`` calls after ``warmup`` calls."""
    _require_cuda()
    _warm(fn, warmup)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with warnings.catch_warnings():
        # "Profiler clears events at the end of each cycle": one cycle.
        warnings.simplefilter("ignore", UserWarning)
        with prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
    totals: Dict[str, float] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            totals[e.name] = (totals.get(e.name, 0.0)
                              + e.time_range.elapsed_us())
    return {k: v / n / 1e6 for k, v in totals.items()}


def profiler_sees_cuda() -> bool:
    """Whether ``torch.profiler`` records the CUDA kernels of this
    process: one small elementwise kernel, profiled up to three times
    (the first session of a process may record none while CUPTI
    starts)."""
    _require_cuda()
    x = torch.ones(1024, device="cuda")
    return any(_kernel_times_s(lambda: x.add(1.0), 1, 1)
               for _ in range(3))


def device_time_s(fn: Callable[[], object], n: int = 20,
                  match: Optional[str] = None, warmup: int = 3) -> float:
    """Mean on-device seconds per call of ``fn``.

    With ``match`` None: CUDA events recorded around each of ``n`` calls
    after ``warmup`` calls (the host's gaps between a call's launches
    count). With ``match``: the summed device time of the profiled CUDA
    kernels whose name contains ``match`` ("" takes every kernel);
    raises :class:`ProfilerUnavailable` if the profiler recorded no CUDA
    kernel at all, RuntimeError if none matches."""
    if match is not None:
        times = _kernel_times_s(fn, n, warmup)
        if not times:
            raise ProfilerUnavailable(
                "torch.profiler recorded no CUDA kernel (CUPTI tracing is "
                "not available to this process); time the kernels with "
                "graph_time_s")
        hit = [v for k, v in times.items() if match in k]
        if not hit:
            raise RuntimeError(f"no CUDA kernel named like {match!r} ran; "
                               f"kernels seen: {sorted(times)}")
        return sum(hit)
    _require_cuda()
    _warm(fn, warmup)
    pairs = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n / 1e3


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if torch.Tag.pointwise in func.tags and name != "clone":
            self.ops += sum(t.numel() for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor))
        elif torch.Tag.reduction in func.tags or name in _SCANS:
            self.ops += args[0].numel()
        return out


def count_ops(fn: Callable[[], object]) -> int:
    """The arithmetic operations of one call of ``fn``, counted from the
    ATen operators it dispatches: each pointwise operator (arithmetic,
    comparison, select, math function) counts one per output element,
    each reduction or scan one per input element; views, copies, dtype
    conversions, creation and indexing count none. Runs ``fn`` once, on
    any device."""
    counter = _OpCounter()
    with counter:
        fn()
    return counter.ops


def collective_bytes(fn: Callable[[], object]) -> Dict[str, int]:
    """The bytes this rank takes in through collectives in one call of
    ``fn``, in slc_tpu's dict of ``hlo_collective_bytes``
    (slc_tpu/devtime.py:91): ``collective-permute`` (halo slabs received,
    zero-filled ones included, as a ``ppermute``'s result shape counts
    them), ``all-reduce`` (each reduced tensor once), ``all-gather``
    (each result), ``reduce-scatter`` (none in the port), ``ops`` and
    ``total``. Read from the counters of ``parallel.halo``, through which
    every collective of ``slc_tpu_torch.parallel`` goes; runs ``fn``
    once."""
    from slc_tpu_torch.parallel import halo
    halo.reset_counts()
    fn()
    out = {k: halo.COUNTS[k] for k in ("collective-permute", "all-reduce",
                                       "all-gather")}
    out["reduce-scatter"] = 0
    out["ops"] = halo.COUNTS["ops"]
    out["total"] = sum(out[k] for k in ("collective-permute", "all-reduce",
                                        "all-gather", "reduce-scatter"))
    return out


#: Replays of the graph that ``graph_time_s`` times.
_REPLAYS = 3


def graph_time_s(fn: Callable[[], object], n: int = 20,
                 warmup: int = 3) -> float:
    """Mean on-device seconds of ``fn``'s kernels alone, without the
    profiler: after ``warmup`` calls, ``n`` calls are captured back to
    back in one CUDA graph (a wrapper counts ``warmup + n`` launches, as
    for :func:`device_time_s`), and CUDA events time each of three
    replays. The replays and their events are queued behind a spin
    kernel, so the host's graph submission stays out of the span (it is
    checked that the device was still spinning when the last was queued;
    the spin grows until it is); the graph's own launch is shared by the
    ``n`` calls. ``fn`` must be capturable: kernels on the current
    stream, no host synchronization."""
    _require_cuda()
    _warm(fn, warmup)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    cycles = 1 << 20
    while True:
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        pairs = []
        for _ in range(_REPLAYS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            graph.replay()
            t1.record()
            pairs.append((t0, t1))
        queued_in_time = not spun.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return (sum(a.elapsed_time(b) for a, b in pairs)
                    / (_REPLAYS * n) / 1e3)
        if cycles >= 1 << 30:
            raise RuntimeError("graph_time_s: the host could not queue "
                               f"{_REPLAYS} replays within a {cycles}-cycle "
                               "spin")
        cycles <<= 2


def rotating(fn: Callable[[object], object],
             sets: Sequence) -> Callable[[], object]:
    """A function of no arguments that calls ``fn`` on ``sets[0]``,
    ``sets[1]``, ... in turn. Each result is held until its set comes
    round again and then freed just before the call that replaces it, so
    the caching allocator gives that call the same output memory: the
    inputs and outputs cycle through ``len(sets)`` places. Timed with
    :func:`graph_time_s` over sets whose bytes exceed the card's L2
    cache, ``fn`` reads and writes device memory, not L2 ("cold")."""
    held = [None] * len(sets)
    turn = itertools.count()

    def call():
        k = next(turn) % len(sets)
        held[k] = None
        held[k] = fn(sets[k])
        return held[k]
    return call
