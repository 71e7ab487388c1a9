#!/usr/bin/env python3
"""Time the bilateral kernel's tile shapes on one CUDA card.

    python3 tools/bilateral_tiles.py

``bilateral_kernel`` (csrc/bilateral.cu) gives a warp a strip of NY rows
of a 128-column tile and a block WARPS such warps stacked down the image.
This script builds this checkout's kernels once more per shape in TILES,
with ``-DSLC_BIL_NY=NY -DSLC_BIL_WARPS=WARPS``, holds each against the
library's own build bit for bit (tools/compare_lock_builds.py's depth maps,
NaN at the same pixels) at 1024x1280 and 1000x1270, and prints each
build's kernels-alone device time there (``devtime.graph_time_s``, 20
calls in one CUDA graph) on the 10%-hole map, L2-resident, and at
1024x1280 also cold (6 input sets rotated, ``devtime.rotating``), the
builds in turns (the library, TILES in order, then in reverse, then the
library again).
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from compare_lock_builds import bits_equal, depth_maps  # noqa: E402
from slc_tpu_torch import devtime  # noqa: E402
from slc_tpu_torch.kernels import _build  # noqa: E402
from slc_tpu_torch.kernels import bilateral as kbil  # noqa: E402

#: (NY, WARPS) shapes to time: a block is 32 x WARPS threads, 128 x (NY *
#: WARPS) pixels.
TILES = ((1, 4), (2, 4), (2, 8), (4, 2), (4, 8), (8, 2), (8, 4), (16, 2))
SHAPES = ((1024, 1280), (1000, 1270))
COLD_SETS = 6


def main() -> int:
    if not torch.cuda.is_available():
        print("bilateral_tiles: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs = {"library": _build.lib()}
    for ny, warps in TILES:
        libs[f"{ny}x{warps}"] = _build.load(_build.build(
            (f"-DSLC_BIL_NY={ny}", f"-DSLC_BIL_WARPS={warps}")))
    order = ["library", *list(libs)[1:], *reversed(list(libs)[1:]),
             "library"]

    def run(lib, fn):
        saved, _build._lib = _build._lib, lib
        try:
            return fn()
        finally:
            _build._lib = saved

    n_diff = 0
    for h, w in SHAPES:
        maps = depth_maps(h, w, dev)
        for name, z in maps.items():
            want = run(libs["library"], lambda: kbil.bilateral_filter_cuda(z))
            differ = [k for k, lib in libs.items() if not bits_equal(
                run(lib, lambda: kbil.bilateral_filter_cuda(z)), want)]
            n_diff += len(differ)
            if differ:
                print(f"{h}x{w} {name}: DIFFER from the library: {differ}")
        z = maps["10% holes"]
        timed = {"L2-resident": lambda: kbil.bilateral_filter_cuda(z)}
        if (h, w) == SHAPES[0]:
            timed[f"cold ({COLD_SETS} input sets rotated)"] = \
                devtime.rotating(kbil.bilateral_filter_cuda,
                                 [z.clone() for _ in range(COLD_SETS)])
        for tag, fn in timed.items():
            t = {k: [] for k in libs}
            for k in order:
                t[k].append(1e3 * devtime.graph_time_s(
                    lambda lib=libs[k]: run(lib, fn)))
            print(f"bilateral at {h}x{w} {tag}, kernels alone (graph of "
                  f"20), NY x WARPS: " + "; ".join(
                      f"{k} {sum(v) / 2:.4f} ms ({v[0]:.4f}, {v[1]:.4f})"
                      for k, v in t.items()), flush=True)
    print(f"{'all' if not n_diff else 'NOT all'} bit-identical; on {card}")
    return 1 if n_diff else 0


if __name__ == "__main__":
    sys.exit(main())
