"""What the traced run reads from ``torch.profiler``: the device's busy
intervals (every kernel, copy and memset on the card), the kernels by
name, and the host spans the harness marked with ``record_function``.
Everything is clipped to the window's own ``record_function`` span."""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

#: The prefix of the harness's host spans, and the window's own span.
SPAN = "slcbench."
WINDOW = SPAN + "window"


def kernel_name(full: str) -> str:
    """A CUDA kernel record's bare function name: no return type,
    namespace, template arguments or parameter list."""
    s = full.strip()
    if s.startswith("void "):
        s = s[5:]
    s = s.replace("(anonymous namespace)::", "")
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.rsplit("::", 1)[-1].strip() or full


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


@dataclasses.dataclass
class Trace:
    """The traced window, read from the profiler's records."""
    window_s: float
    busy_s: float
    #: bare kernel name -> (launches, device seconds); empty when the
    #: profiler recorded no CUDA kernel.
    kernels: Dict[str, Tuple[int, float]]
    #: device operation (kernels by bare name, copies by kind) ->
    #: seconds, for the breakdown.
    device_ops: Dict[str, float]
    #: idle device seconds by the innermost host span around each gap.
    idle_by_span: Dict[str, float]

    @property
    def saw_device(self) -> bool:
        return bool(self.device_ops)


def read(prof, whole: bool = False) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a Trace; with
    ``whole``, the profile is the window (a profile of the device alone
    holds no host span to clip to)."""
    events = prof.profiler.kineto_results.events()
    win: Optional[Tuple[int, int]] = None
    spans: List[Tuple[int, int, str]] = []
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        start = _ns(e, "start")
        end = start + int(e.duration_ns() if hasattr(e, "duration_ns")
                          else e.duration_us() * 1000)
        if name.startswith(SPAN) and e.device_type() != \
                torch.autograd.DeviceType.CPU:
            continue        # a host span's mirror on the device timeline
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((start, end, name))
        elif name == WINDOW:
            win = (start, end)
        elif name.startswith(SPAN):
            spans.append((start, end, name[len(SPAN):]))
    if whole and dev:
        win = (min(s for s, _, _ in dev), max(e for _, e, _ in dev))
    if win is None:
        raise RuntimeError(f"the profiler holds no {WINDOW!r} span")
    w0, w1 = win
    kernels: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0, 0.0])
    ops: Dict[str, float] = collections.defaultdict(float)
    clipped = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        sec = (e - s) * 1e-9
        if name.startswith(("Memcpy", "Memset")):
            ops[name.split(" (")[0]] += sec
            continue
        k = kernel_name(name)
        kernels[k][0] += 1
        kernels[k][1] += sec
        ops[k] += sec
    busy, gaps = 0, []
    cur = None
    for s, e in sorted(clipped):
        if cur is None:
            if s > w0:
                gaps.append((w0, s))
            cur = [s, e]
        elif s <= cur[1]:
            cur[1] = max(cur[1], e)
        else:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
    if cur is not None:
        busy += cur[1] - cur[0]
        if cur[1] < w1:
            gaps.append((cur[1], w1))
    else:
        gaps.append((w0, w1))
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                 kernels={k: (int(n), t) for k, (n, t) in kernels.items()},
                 device_ops=dict(ops),
                 idle_by_span=_attribute(gaps, spans))


def _attribute(gaps, spans) -> Dict[str, float]:
    """Each idle gap's seconds go to the innermost host span (the latest
    started) that holds its midpoint, else to "host outside spans"."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    out: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "host outside spans"
        i = bisect.bisect_right(starts, mid) - 1
        # Spans nest at most a few deep: walk back to the innermost that
        # still holds the midpoint.
        for j in range(i, max(i - 8, -1), -1):
            s, e, name = spans[j]
            if s <= mid < e:
                label = name
                break
        out[label] += (g1 - g0) * 1e-9
    return dict(out)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` largest entries as [name, seconds], largest first."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
