"""Structured per-frame metrics and stage timing (PyTorch port of
slc_tpu/metrics.py).

Every frame yields a record (valid-pixel fraction, z range, wall-clock
fps) and stages are timed under ``torch.profiler.record_function``
annotations, so a profiler trace (:func:`device_trace`) shows them by
name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import torch

from slc_tpu_torch import devtime

_STATS = ("valid_frac", "z_min", "z_max", "z_mean")


def _stats_tensor(z: torch.Tensor) -> torch.Tensor:
    """The four per-frame stats of one depth map, as a (4,) tensor on its
    device."""
    valid = z > 0
    any_valid = valid.any()
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    return torch.stack([
        valid.float().mean(),
        torch.where(any_valid, torch.where(valid, z, torch.inf).min(),
                    zero),
        torch.where(any_valid, torch.where(valid, z, -torch.inf).max(),
                    zero),
        torch.where(valid, z, zero).sum()
        / valid.sum().clamp(min=1).to(z.dtype),
    ])


def frame_stats(z: torch.Tensor) -> Dict[str, float]:
    """Per-frame stats of a depth map (z > 0 is valid), reduced on the
    device and read back in one transfer."""
    return dict(zip(_STATS, _stats_tensor(z).tolist()))


def frame_stats_many(zs) -> List[Dict[str, float]]:
    """:func:`frame_stats` of each depth map of ``zs`` (a (K, H, W) stack
    or a sequence of maps), the same reductions map by map, read back in
    one transfer for all of them."""
    rows = torch.stack([_stats_tensor(z) for z in zs]).tolist()
    return [dict(zip(_STATS, row)) for row in rows]


@dataclasses.dataclass
class MetricsLog:
    """Accumulates per-frame records; writes JSON lines.

    Stage timings recorded via :func:`stage` between two ``log_frame``
    calls are folded into the next frame's record as ``t_<stage>_ms``
    (and ``gbps_<stage>`` when the bytes moved are known).
    """

    records: List[dict] = dataclasses.field(default_factory=list)
    #: Run-level summary records (the async writer's totals, the period
    #: diagnostic); written after the frame records.
    summaries: List[dict] = dataclasses.field(default_factory=list)
    _t_last: Optional[float] = None
    _pending_stages: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def log_stage(self, name: str, wall_s: float,
                  bytes_moved: Optional[int] = None) -> None:
        """Record one stage timing, attached to the next log_frame."""
        short = name.rsplit("/", 1)[-1]
        entry = {f"t_{short}_ms": round(wall_s * 1e3, 3)}
        if bytes_moved is not None and wall_s > 0:
            gbps = bytes_moved / wall_s / 1e9
            entry[f"gbps_{short}"] = float(f"{gbps:.3g}")
        self._pending_stages.update(entry)

    def log_frame(self, frame_idx: int, stats: Dict[str, float],
                  **extra) -> dict:
        now = time.perf_counter()
        fps = (1.0 / (now - self._t_last)
               if self._t_last is not None else None)
        self._t_last = now
        rec = {"frame": int(frame_idx),
               **{k: float(v) for k, v in stats.items()},
               **self._pending_stages,
               **extra}
        self._pending_stages = {}
        if fps is not None:
            rec["fps"] = round(fps, 2)
        self.records.append(rec)
        return rec

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records + self.summaries:
                f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def stage(name: str, log: Optional[MetricsLog] = None,
          bytes_moved: Optional[int] = None, device=None):
    """Profiler annotation + wall clock. On a CUDA ``device`` the block
    ends by synchronizing the device's current stream, so the wall time
    covers the device work launched inside it, not just its enqueueing,
    and not a copy that another stream runs meanwhile (the streaming
    loop's transfer of the next frame)."""
    device = torch.device(device) if device is not None else None
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        yield
        if device is not None and device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        wall = time.perf_counter() - t0
    if log is not None:
        log.log_stage(name, wall, bytes_moved)


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace into ``log_dir`` (``trace_<pid>_<ns>.json``; slc_tpu's
    ``jax.profiler`` trace). On a CUDA ``device`` the trace holds CPU and
    CUDA activity; where CUPTI cannot trace the card, it raises
    ``devtime.ProfilerUnavailable`` before the block runs and writes
    nothing. ``device="cpu"`` traces CPU activity alone."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not devtime.profiler_sees_cuda():
            raise devtime.ProfilerUnavailable(
                "torch.profiler records no CUDA kernel in this process "
                "(CUPTI tracing is not available): no device trace")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
