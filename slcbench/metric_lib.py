"""Shared arithmetic of the per-layer metrics' readers. A reader that
finds nothing to read returns None, and the run leaves the metric out."""

from __future__ import annotations

from typing import Optional, Sequence


def span_mean_ms(run, name: str) -> Optional[float]:
    """Mean milliseconds of the harness's host span ``name``, each ended
    by a synchronisation of the current stream."""
    t = run.spans.get(name)
    return 1e3 * sum(t) / len(t) if t else None


def roofline_pct(run, kernels: Sequence[str], call_kernel: str,
                 bytes_per_call: float) -> Optional[float]:
    """The least time the card could take for the calls in the traced
    window (the bytes each call needs over the card's published memory
    rate) as a share of the device time of ``kernels`` in the profiler's
    records. The calls are counted by ``call_kernel``'s launches, one per
    call. None where the profiler recorded none of them or the card is
    not in peaks.json."""
    tr = run.trace
    if tr is None or run.hbm_bytes_per_s is None:
        return None
    calls = tr.kernels.get(call_kernel, (0, 0.0))[0]
    t = sum(tr.kernels[k][1] for k in kernels if k in tr.kernels)
    if not calls or t <= 0:
        return None
    return 100.0 * calls * bytes_per_call / run.hbm_bytes_per_s / t


def pixels(run) -> int:
    s = run.config["system"]
    return s["cam_h"] * s["cam_w"]


def idle_pct(run) -> Optional[float]:
    """Share of the traced window in which no kernel, copy or memset ran
    on the card (the union of the profiler's device records)."""
    tr = run.trace
    if tr is None or not tr.saw_device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
