"""The program's spans and counters (``slc_tpu_torch.metrics``) on the CPU:
a tracked loop records nothing without a profiler and each span once per
call under one; a span's self time is its total less its children's; a
span is a CPU op of the profiler, not a user annotation, and carries its
frame; ``stage`` keeps its ``metrics.jsonl`` keys and opens no profiler
range without a profiler; and the frame stager's C entry points
(``kernels/csrc/staging.cu``, built here by g++ against a stub of the
CUDA runtime that runs a host function at once) check their arguments
and time a copy only when asked, and ``counters()`` reports what they
timed."""

import ctypes
import json
import os
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

from slc_tpu_torch import metrics, streaming, synth
from slc_tpu_torch.calib import build_tables, synthetic_calibration
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.dynamic import init_tracker
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.ops import demod
from slc_tpu_torch.pipeline import decode_first_frame

torch.set_num_threads(2)

CFG = SystemConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
N_FRAMES = 5
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def clean():
    metrics.reset()
    yield
    metrics.reset()


@pytest.fixture(scope="module")
def scene():
    calib = synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                  pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tables = build_tables(calib, CFG.cam_h, CFG.cam_w, device="cpu")
    first = synth.render_static_scene(calib, CFG, synth.plane_surface(50.0))
    frames, _, _ = synth.render_dynamic_sequence(calib, CFG, N_FRAMES + 1,
                                                 stripe_period=12)
    return tables, first, frames


def _tracked_loop(scene):
    """One sequence as the runner's stream mode runs it: the frame-0
    decode, the lock window, the period diagnostic, the tracker's init,
    then the streaming loop (a put, a step and a fetch a frame)."""
    tables, first, frames = scene
    res = decode_first_frame(torch.from_numpy(first.gray_images),
                             torch.from_numpy(first.phase_images), tables,
                             CFG)
    win = demod.suggest_lock_window(res.proj_u, 12.0)
    float(demod.estimate_period(torch.from_numpy(frames[0]), res.proj_u,
                                12.0, win_u=win))
    state = init_tracker(torch.from_numpy(frames[0]), res.proj_u, res.z,
                         CFG)
    for state, _ in streaming.stream_frames(state, frames[1:], tables, CFG):
        pass
    return state


def test_without_a_profiler_nothing_is_recorded(scene):
    assert not metrics.recording()
    state = _tracked_loop(scene)
    assert state.frame_idx == N_FRAMES
    assert metrics.span_totals() == {}
    assert metrics.counters() == {}
    assert metrics.span("track.step") is metrics.span("stream.put")


def test_a_profiled_loop_records_each_call(scene):
    with torch.profiler.profile(activities=CPU):
        _tracked_loop(scene)
    spans = metrics.span_totals()
    assert spans["track.step"]["calls"] == N_FRAMES
    assert spans["stream.put"]["calls"] == N_FRAMES
    assert spans["stream.fetch"]["calls"] == N_FRAMES
    for name in ("decode.first", "setup.lock_window", "setup.period",
                 "track.init"):
        assert spans[name]["calls"] == 1, name
    for s in spans.values():
        assert 0 < s["max_ns"] <= s["total_ns"]
        assert 0 <= s["self_ns"] <= s["total_ns"]
    # The CPU's staging copy runs inside each put: a job, no delay.
    c = metrics.counters()
    assert set(c) == {"stage.jobs", "stage.copy_ns"}
    assert c["stage.jobs"] == N_FRAMES and c["stage.copy_ns"] > 0
    # Nothing more once the profiler has stopped.
    _tracked_loop(scene)
    assert metrics.span_totals() == spans


def test_self_time_is_total_less_children():
    with torch.profiler.profile(activities=CPU):
        with metrics.span("outer"):
            time.sleep(0.002)
            with metrics.span("inner"):
                time.sleep(0.002)
                with metrics.span("leaf"):
                    time.sleep(0.001)
            with metrics.span("inner"):
                time.sleep(0.001)
        metrics.count("things", 3)
        metrics.count("things")
    s = metrics.span_totals()
    assert s["inner"]["calls"] == 2 and s["outer"]["calls"] == 1
    assert s["outer"]["self_ns"] == (s["outer"]["total_ns"]
                                     - s["inner"]["total_ns"])
    assert s["inner"]["self_ns"] == (s["inner"]["total_ns"]
                                     - s["leaf"]["total_ns"])
    assert s["leaf"]["self_ns"] == s["leaf"]["total_ns"] >= 1_000_000
    assert s["outer"]["self_ns"] >= 2_000_000
    assert s["inner"]["max_ns"] >= 3_000_000
    assert metrics.counters() == {"things": 4}
    metrics.reset()
    assert metrics.span_totals() == {} and metrics.counters() == {}


def test_a_span_is_a_cpu_op_carrying_its_frame(tmp_path):
    frame = np.arange(CFG.cam_h * CFG.cam_w, dtype=np.uint8).reshape(
        CFG.cam_h, CFG.cam_w)
    stager = streaming.HostStager("cpu")
    with torch.profiler.profile(activities=CPU, record_shapes=True) as prof:
        with metrics.span("outer", frame=7):
            staged = [stager.put(frame) for _ in range(3)]
    assert [s.frame for s in staged] == [1, 2, 3]
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("slc.")]
    assert sorted(e.name() for e in ours) == ["slc.outer"] + [
        "slc.stream.put"] * 3
    for e in ours:
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if str(e.get("name", "")).startswith("slc.")]
    assert {e["cat"] for e in events} == {"cpu_op"}
    assert [e["args"]["frame"] for e in events
            if e["name"] == "slc.outer"] == [7]
    assert sorted(e["args"]["frame"] for e in events
                  if e["name"] == "slc.stream.put") == [1, 2, 3]


def test_stage_keeps_its_keys_and_opens_no_range_unprofiled(monkeypatch):
    def no_range(*a, **k):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    monkeypatch.setattr(metrics, "_RecordFunctionFast", no_range)
    log = metrics.MetricsLog()
    with metrics.stage("slc/dynamic_step", log, bytes_moved=1_000_000):
        time.sleep(0.002)
    with metrics.stage("slc/write", log):
        pass
    rec = log.log_frame(1, {})
    assert {"t_dynamic_step_ms", "gbps_dynamic_step",
            "t_write_ms"} <= set(rec)
    assert rec["t_dynamic_step_ms"] >= 2.0
    assert metrics.span_totals() == {}
    monkeypatch.undo()
    with torch.profiler.profile(activities=CPU):
        with metrics.stage("slc/dynamic_step", log):
            pass
    assert metrics.span_totals()["stage.dynamic_step"]["calls"] == 1
    assert "t_dynamic_step_ms" in log.log_frame(2, {})


#: Enough of cuda_runtime.h for csrc/staging.cu on the host: a host
#: function runs at once, a device copy is a memcpy.
STUB_RUNTIME = r"""
#pragma once
#include <cstddef>
#include <cstring>
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorMemoryAllocation = 2 };
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1 };
#define CUDART_CB
typedef void (*cudaHostFn_t)(void*);
inline cudaError_t cudaLaunchHostFunc(cudaStream_t, cudaHostFn_t fn,
                                      void* arg) {
  fn(arg);
  return cudaSuccess;
}
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n,
                                   cudaMemcpyKind, cudaStream_t) {
  memcpy(dst, src, n);
  return cudaSuccess;
}
"""


@pytest.fixture(scope="module")
def staging_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/staging.cu on the host")
    d = tmp_path_factory.mktemp("staging")
    (d / "cuda_runtime.h").write_text(STUB_RUNTIME)
    src = os.path.join(os.path.dirname(_build.__file__), "csrc",
                       "staging.cu")
    out = str(d / "libstaging.so")
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-I", str(d), "-o", out, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.slc_stage_h2d.argtypes = _build._SIGNATURES["slc_stage_h2d"]
    lib.slc_stage_h2d.restype = ctypes.c_int
    lib.slc_stage_stats.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.slc_stage_stats.restype = None
    return lib


def _stats(lib, reset=0):
    out = (ctypes.c_longlong * 4)()
    lib.slc_stage_stats(out, reset)
    return tuple(out)


def test_stage_h2d_checks_its_arguments_and_times_when_asked(staging_lib):
    lib = staging_lib
    _stats(lib, reset=1)
    rng = np.random.default_rng(3)
    parts = [rng.integers(0, 256, (256, 1024), dtype=np.uint8)
             for _ in range(2)]
    n = parts[0].nbytes
    src = (ctypes.c_void_p * 2)(*(p.ctypes.data for p in parts))
    pinned = np.zeros(2 * n, np.uint8)
    dev = np.zeros(2 * n, np.uint8)
    args = (pinned.ctypes.data, dev.ctypes.data)
    # No part to copy: refused, nothing copied, nothing counted.
    assert lib.slc_stage_h2d(src, 0, n, *args, 1, None) == 1
    assert not dev.any() and _stats(lib) == (0, 0, 0, 0)
    # Untimed: copied, nothing counted.
    assert lib.slc_stage_h2d(src, 2, n, *args, 0, None) == 0
    want = np.concatenate([p.ravel() for p in parts])
    np.testing.assert_array_equal(pinned, want)
    np.testing.assert_array_equal(dev, want)
    assert _stats(lib) == (0, 0, 0, 0)
    # Timed: one job, its delay and its copy.
    for _ in range(3):
        assert lib.slc_stage_h2d(src, 2, n, *args, 1, None) == 0
    jobs, delay, delay_max, copy = _stats(lib)
    assert jobs == 3 and copy > 0
    assert 0 <= delay_max <= delay
    assert _stats(lib, reset=1) == (jobs, delay, delay_max, copy)
    assert _stats(lib) == (0, 0, 0, 0)
    np.testing.assert_array_equal(dev, want)


def test_counters_report_the_stagers_timings_once_it_timed_a_copy(
        monkeypatch):
    """``counters()`` adds the kernel library's ``stage.*`` timings to the
    program's counters where a copy was timed, and nothing where none
    was; ``reset()`` zeroes them."""
    calls = []

    def stats(reset=False):
        calls.append(reset)
        return dict(zip(_build.STAGE_STATS, jobs))

    monkeypatch.setattr(_build, "stage_stats", stats)
    jobs = (0, 0, 0, 0)
    with torch.profiler.profile(activities=CPU):
        metrics.count("things", 2)
        metrics.count("stage.jobs")
        metrics.count("stage.copy_ns", 100)
    assert metrics.counters() == {"things": 2, "stage.jobs": 1,
                                  "stage.copy_ns": 100}
    jobs = (3, 900, 500, 1200)
    assert metrics.counters() == {
        "things": 2, "stage.jobs": 4, "stage.fn_delay_ns": 900,
        "stage.fn_delay_max_ns": 500, "stage.copy_ns": 1300}
    metrics.reset()
    assert calls[-1] is True
