"""One run of one benchmark cell: set-up, the measured window, the
output check, and the result line.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``configs/<name>.json``, its traffic mix in
``traffic/<name>.json``, the driver the mix names in
``drivers/<driver>.py``, each per-layer metric's reader in
``metrics/<metric>.py`` and the cell's check limits in
``checks/<cell>.json``. A new cell, mix, configuration or metric is new
files; no file here needs an edit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from slcbench import trace as tracemod

HERE = os.path.dirname(os.path.abspath(__file__))
#: Top-level module names that must not be loaded by the end of a run:
#: the JAX stack and the JAX package the port was made from. Compared
#: whole: ``slc_tpu_torch`` is the program, not ``slc_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "slc_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is in FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find(bench_dir: str, kind: str, name: str, ext: str) -> str:
    """``<bench_dir>/<kind>/<name><ext>``; raises if it is missing."""
    path = os.path.join(bench_dir, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    return path


def load_module(bench_dir: str, kind: str, name: str):
    """Import ``<bench_dir>/<kind>/<name>.py`` by path (metric names hold
    dots, so they are no package names)."""
    path = find(bench_dir, kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"slcbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spans:
    """Host spans around the calls into each layer, on in the traced run
    only: each ends in a synchronisation of the current stream, is marked
    for the profiler's timeline, and its seconds are kept by name."""

    def __init__(self, on: bool, sync: Callable[[], None]):
        self.on = on
        self.sync = sync
        self.times: Dict[str, List[float]] = {}
        self._off = contextlib.nullcontext()

    def __call__(self, name: str):
        return self._span(name) if self.on else self._off

    @contextlib.contextmanager
    def _span(self, name: str):
        with torch.profiler.record_function(tracemod.SPAN + name):
            t0 = time.perf_counter()
            yield
            self.sync()
            self.times.setdefault(name, []).append(time.perf_counter() - t0)


@dataclasses.dataclass
class Cell:
    """What a driver is given: the cell's entry, its configuration and
    mix, the seed, the device, the spans and the check's bars."""
    name: str
    config: dict
    traffic: dict
    checks: dict
    seed: int
    device: torch.device
    spans: Spans


class Tally:
    """Each map's latency and delivery time as a driver records them."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.latencies_s: List[float] = []
        self.done_s: List[float] = []

    def add(self, start: float) -> None:
        """A map delivered now, its images handed over at ``start``."""
        t = time.perf_counter()
        self.latencies_s.append(t - start)
        self.done_s.append(t - self.t0)

    def window(self) -> "Window":
        return Window(self.latencies_s, self.done_s,
                      time.perf_counter() - self.t0)


@dataclasses.dataclass
class Window:
    """The measured window: one latency and delivery time per map, in
    order, and the window's wall time."""
    latencies_s: List[float]
    done_s: List[float]
    wall_s: float

    @property
    def attempted(self) -> int:
        return len(self.latencies_s)

    def per_second(self) -> List[int]:
        """Maps delivered in each second of the window."""
        counts = [0] * (int(self.wall_s) + 1)
        for t in self.done_s:
            counts[min(int(t), len(counts) - 1)] += 1
        return counts


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader reads."""
    config: dict
    latencies_s: List[float]
    spans: Dict[str, List[float]]
    trace: Optional[tracemod.Trace]
    hbm_bytes_per_s: Optional[float]
    wall_s: Optional[float] = None


def make_cell(bench: dict, bench_dir: str, workload: str, seed: int,
              device, spans: Spans) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    return Cell(name=workload,
                config=load_json(find(bench_dir, "configs", w["config"],
                                      ".json")),
                traffic=load_json(find(bench_dir, "traffic", w["traffic"],
                                       ".json")),
                checks=load_json(find(bench_dir, "checks", workload,
                                      ".json")),
                seed=seed, device=torch.device(device), spans=spans)


def make_driver(cell: Cell, bench_dir: str):
    return load_module(bench_dir, "drivers",
                       cell.traffic["driver"]).Driver(cell)


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones
    with ``trace`` off, its per-layer ones with it on."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(win: Window, setup_s: float) -> Dict[str, float]:
    """maps_per_s over every map and the whole window; map_p95_ms over
    every map's latency; setup_s."""
    return {"maps_per_s": len(win.latencies_s) / win.wall_s,
            "map_p95_ms": 1e3 * percentile(win.latencies_s, 95),
            "setup_s": setup_s}


def check_numbers(numbers: Dict[str, float], checks: dict) -> Dict[str, dict]:
    """Each compared number beside its limit, in the check file's order;
    a number the driver did not give is NaN and fails."""
    return {k: {"value": float(numbers.get(k, math.nan)),
                "limit": float(v["limit"])}
            for k, v in checks["limits"].items()}


def is_correct(checked: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())


def card_line(device) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    idx = torch.device(device).index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={idx}"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def hbm_peak(bench_dir: str, kind: str) -> Optional[float]:
    """The card's published memory rate from ``peaks.json``, or None for
    a card not in the table."""
    peaks = load_json(os.path.join(bench_dir, "peaks.json"))
    entry = peaks["cards"].get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(bench: dict, bench_dir: str, workload: str, seed: int,
             seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run one cell once and return its result line as a dict. Raises on
    any failure of the program or the harness."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.current_stream(dev).synchronize()

    spans = Spans(trace, sync)
    cell = make_cell(bench, bench_dir, workload, seed, dev, spans)
    drv = make_driver(cell, bench_dir)
    drv.setup()
    # End-to-end metrics read from the device's trace: the untraced
    # window then runs under a profiler of the device alone.
    device_e2e = cuda and not trace and any(
        m["source"] == "device_trace"
        for m in cell_metrics(bench, workload, False))
    if (trace or device_e2e) and cuda:
        # The first profiler session of a process may record no kernel
        # while CUPTI starts.
        x = torch.ones(1024, device=dev)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            x.add_(1.0)
            sync()
    sync()
    # Set-up's objects live as long as the run: keep the collector from
    # walking them in the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        with torch.profiler.record_function(tracemod.WINDOW):
            win = drv.window(seconds)
        sync()
        prof.stop()
    elif device_e2e:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        win = drv.window(seconds)
        sync()
        prof.stop()
    else:
        win = drv.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    card = card_line(dev) if cuda else "cpu"

    lat = win.latencies_s
    log(f"card: {card}; maps per second of the window {win.per_second()}")
    log(f"maps: {len(lat)} in {win.wall_s:.3f} s; latency median "
        f"{1e3 * percentile(lat, 50):.4f} ms, p95 "
        f"{1e3 * percentile(lat, 95):.4f} ms; setup {setup_s:.3f} s")

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    result: dict = {}
    metrics: Dict[str, dict] = {}
    if trace:
        tr = tracemod.read(prof)
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        run = Run(config=cell.config, latencies_s=win.latencies_s,
                  spans=spans.times, trace=tr,
                  hbm_bytes_per_s=hbm_peak(bench_dir, kind),
                  wall_s=win.wall_s)
        if not tr.saw_device:
            log("trace: the profiler recorded no operation on the device; "
                "the device metrics read null")
        for m in cell_metrics(bench, workload, True):
            v = load_module(bench_dir, "metrics", m["name"]).read(run)
            if v is None:
                log(f"metric {m['name']}: nothing to read")
            else:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tracemod.top(tr.device_ops),
                               "idle_gaps": tracemod.top(tr.idle_by_span)}
    else:
        e2e = end_to_end(win, setup_s)
        run = Run(config=cell.config, latencies_s=win.latencies_s,
                  spans={}, trace=tracemod.read(prof, whole=True)
                  if device_e2e else None, hbm_bytes_per_s=None,
                  wall_s=win.wall_s)
        for m in cell_metrics(bench, workload, False):
            if m["source"] != "device_trace":
                v = e2e[m["name"]]
            else:
                v = load_module(bench_dir, "metrics", m["name"]).read(run)
            if v is None:
                log(f"metric {m['name']}: nothing to read")
            else:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # The check runs once the window has closed, the peak is read and
    # the program's state is freed.
    drv.release()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = drv.check()
    checked = check_numbers(numbers, cell.checks)
    log(f"check: {drv.checked} in {time.perf_counter() - t0:.3f} s")

    # A map that fails raises and ends the run: a run that prints failed
    # none.
    out = {"correct": is_correct(checked), "attempted": win.attempted,
           "failed": 0, "metrics": metrics, "device": device_info}
    out.update(result)
    for k, c in checked.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    out["checks"] = checked
    # Last, so that whatever the window, the trace's reading or the check
    # loaded is seen.
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"modules of the JAX stack or the JAX package "
                           f"were loaded: {loaded}")
    return out
