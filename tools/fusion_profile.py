#!/usr/bin/env python3
"""Where the time of multi-scan registration goes, on one CUDA card.

    python3 tools/fusion_profile.py

Builds chip_smoke.py's 16-scan 2 MP problem (``fusion_problem``:
bench.py's config-5 frontend), runs ``register_scans`` once to warm up,
then:

1. its wall time (synchronised) and each stage's (``timings``), as
   chip_smoke.py prints them;
2. one point-to-plane step and one association alone, device time by
   CUDA events (``devtime.device_time_s``, 20 calls after 3 warm-ups);
3. one ``register_scans`` under ``torch.profiler``: its CUDA kernels'
   summed device time against the wall (the device's busy and idle
   share), the number of kernels, and the operators that take the most
   device time. Where the profiler records no CUDA kernel, those lines
   say "not measured".
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from slc_tpu_torch import devtime, fusion  # noqa: E402
from slc_tpu_torch.fusion_frontend import (associate_projective,  # noqa
                                           register_scans)


def main() -> int:
    if not torch.cuda.is_available():
        print("fusion_profile: CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    args, kw, _ = chip_smoke.fusion_problem()
    register_scans(*args, device="cuda", **kw)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    register_scans(*args, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    stages = {}
    register_scans(*args, device="cuda", timings=stages, **kw)
    print(f"register_scans {wall:.3f} ms wall; by stage (each "
          f"synchronised) " + ", ".join(f"{k} {v:.3f} ms"
                                        for k, v in stages.items()))

    depths, cam_k, rot, trans = (torch.tensor(a, device="cuda")
                                 for a in args)
    obs, mask, lm, normals = associate_projective(
        depths, cam_k, rot, trans, kw["grid_step"], kw["max_depth_err"])
    assoc = 1e3 * devtime.device_time_s(lambda: associate_projective(
        depths, cam_k, rot, trans, kw["grid_step"], kw["max_depth_err"]))

    def step():
        with fusion.full_f32():
            fusion._gn_step_p2l(rot, trans, lm, normals, obs, mask, 1e-3)
    gn = 1e3 * devtime.device_time_s(step)
    print(f"one association {assoc:.3f} ms, one point-to-plane step "
          f"{gn:.3f} ms (CUDA events, call incl. host gaps); "
          f"{obs.shape[1]} landmarks, {int(mask.sum())} observations")

    if not devtime.profiler_sees_cuda():
        print("device busy share and top operators: not measured (the "
              "profiler records no CUDA kernel in this process)")
        return 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        register_scans(*args, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            kernels[e.name] = kernels.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    print(f"profiled register_scans {wall:.3f} ms wall, {n} CUDA kernels, "
          f"{busy:.3f} ms of device time: busy {100 * busy / wall:.1f}%, "
          f"idle {100 - 100 * busy / wall:.1f}% (the profiler's own host "
          f"cost included in the wall)")
    print("top CUDA kernels by device time (ms):")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:.3f}  {name[:110]}")

    def dev_total(a):
        v = getattr(a, "self_device_time_total", None)
        return a.self_cuda_time_total if v is None else v
    print("top operators by self device time (ms, calls):")
    for a in sorted(prof.key_averages(), key=dev_total, reverse=True)[:15]:
        print(f"  {a.key}: {dev_total(a) / 1e3:.3f} ms, {a.count} calls")
    return 0


if __name__ == "__main__":
    sys.exit(main())
