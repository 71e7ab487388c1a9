#!/usr/bin/env python3
"""Time the multigrid level kernels' tile shapes (``mg_down`` and
``mg_up``) at each multigrid level shape, on one CUDA card.

    python3 tools/mg_up_tiles.py

``mg_level_kernel`` (csrc/mgsmooth.cu) gives a block TH rows of 128
columns and a thread a strip of NY rows; ``slc_mg_down`` and ``slc_mg_up``
pick (TH, NY) from the level's shape. This script builds this checkout's
kernels once more per shape in TILES, with ``-DSLC_MG_DOWN_TH=TH
-DSLC_MG_DOWN_NY=NY -DSLC_MG_UP_TH=TH -DSLC_MG_UP_NY=NY`` (profiling
builds: every level of both kernels takes that shape), holds each against
the library's own build bit for bit on random levels (chip_smoke.py's
``mg_level``) at the level shapes of chip_smoke.py's two chains, and
prints each build's kernels-alone device time of each kernel there
(``devtime.graph_time_s``, 20 calls in one CUDA graph), the builds in
turns (the library, TILES in order, then in reverse, then the library
again).
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import SHAPES, level_chain, mg_level  # noqa: E402
from slc_tpu_torch import devtime  # noqa: E402
from slc_tpu_torch.kernels import _build  # noqa: E402
from slc_tpu_torch.kernels import mgsmooth as kmg  # noqa: E402

#: (TH, NY) shapes to time; TH % NY == 0, 32 * TH / NY threads a block.
TILES = ((40, 4), (20, 4), (16, 2), (8, 2), (8, 1), (4, 1))


def main() -> int:
    if not torch.cuda.is_available():
        print("mg_up_tiles: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs = {"library": _build.lib()}
    for th, ny in TILES:
        libs[f"{th}x{ny}"] = _build.load(_build.build(
            (f"-DSLC_MG_DOWN_TH={th}", f"-DSLC_MG_DOWN_NY={ny}",
             f"-DSLC_MG_UP_TH={th}", f"-DSLC_MG_UP_NY={ny}")))
    order = ["library", *list(libs)[1:], *reversed(list(libs)[1:]),
             "library"]
    n_diff = 0
    for h, w in SHAPES:
        for lh, lw in level_chain(h, w):
            r, e, wy, wx, dinv = mg_level(dev, lh, lw)
            kernels = {"mg_down": lambda: kmg.mg_down_cuda(r, wy, wx, dinv),
                       "mg_up": lambda: (kmg.mg_up_cuda(e, r, wy, wx,
                                                        dinv),)}
            for name, fn in kernels.items():

                def run(lib, fn=fn):
                    saved, _build._lib = _build._lib, lib
                    try:
                        return fn()
                    finally:
                        _build._lib = saved

                want = run(libs["library"])
                differ = [k for k, lib in libs.items()
                          if not all(torch.equal(a, b)
                                     for a, b in zip(run(lib), want))]
                n_diff += len(differ)
                t = {k: [] for k in libs}
                for k in order:
                    t[k].append(1e3 * devtime.graph_time_s(
                        lambda lib=libs[k]: run(lib)))
                print(f"{name} at {lh}x{lw}, kernels alone (graph of 20), "
                      f"TH x NY: " + "; ".join(
                          f"{k} {sum(v) / 2:.4f} ms ({v[0]:.4f}, "
                          f"{v[1]:.4f})" for k, v in t.items())
                      + (f"; DIFFER from the library: {differ}" if differ
                         else "; all bit-identical"), flush=True)
    print(f"on {card}")
    return 1 if n_diff else 0


if __name__ == "__main__":
    sys.exit(main())
