"""Shared arithmetic of the per-layer metrics read from the program's own
spans and counters (``slc_tpu_torch.metrics``: sources ``program_span``
and ``program_counter``).

The program records them only while a profiler runs, which in a run is
the traced window alone. The yardstick imports nothing of the program:
these functions read the aggregates of the module the run has loaded,
and find nothing where it is not loaded, where it keeps no spans (a
program older than its spans) or where the run was not traced."""

from __future__ import annotations

import sys
from typing import Dict, Optional

MODULE = "slc_tpu_torch.metrics"


def _read(run, fn: str) -> Optional[dict]:
    if run.trace is None:
        return None
    read = getattr(sys.modules.get(MODULE), fn, None)
    return read() if read is not None else None


def spans(run) -> Optional[Dict[str, Dict[str, int]]]:
    """Each program span's calls, total, self and max ns in the window."""
    return _read(run, "span_totals")


def counters(run) -> Optional[Dict[str, int]]:
    """The program's counters in the window."""
    return _read(run, "counters")


def mean_ms(run, name: str) -> Optional[float]:
    """Mean host ms per call of the span ``name`` (no stream sync)."""
    s = (spans(run) or {}).get(name)
    return s["total_ns"] / s["calls"] / 1e6 if s and s["calls"] else None


def per_call_ms(run, name: str, per: str, field: str) -> Optional[float]:
    """``field`` (``total_ns`` or ``self_ns``) of the span ``name`` summed
    over the window, in ms per call of the span ``per``: 0 where ``per``
    ran and ``name`` did not."""
    s = spans(run) or {}
    calls = s.get(per, {}).get("calls")
    if not calls:
        return None
    return s.get(name, {}).get(field, 0) / calls / 1e6


def ratio_ms(run, num: str, den: str) -> Optional[float]:
    """The counter ``num`` (ns) over the counter ``den``, in ms."""
    c = counters(run) or {}
    return c.get(num, 0) / c[den] / 1e6 if c.get(den) else None
