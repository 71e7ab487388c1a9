"""Readings that set the check's limits, on the chip at a cell's own size.

    python3 slcbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--order-seeds 7,8,9] [--seconds 3]

For each of ``--seeds``: the cell's set-up, a short window of the timed
path at the cell's load and the check, as a run makes them (the lower
readings). For each of ``--control-seeds``: the control, the reference
computed in bfloat16 in the program's place on the maps a run checks,
against the reference in the precision the check holds the program to
(the upper readings). For each of ``--order-seeds``, in a cell whose
driver offers it (``order_control``): the reference against itself with
its sums taken in another order, drawn from the seed (the spread of
sound float32 implementations, whatever the program does). One JSON
line per seed; everything in one process, so the set-up is paid once
per seed and the kernels are built once. The benchmark's runs do not
run this.
"""

import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from slcbench import harness  # noqa: E402

#: The control's precision: the nearest below the configurations' float32
#: for arithmetic that has no matrix product (TF32 would change nothing).
CONTROL_DTYPE = torch.bfloat16


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--order-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda:0")
    a = p.parse_args(argv)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    dev = torch.device(a.device)
    spans = harness.Spans(False, lambda: None)
    groups = (("program", a.seeds), ("control", a.control_seeds),
              ("order", a.order_seeds))
    for kind, group in groups:
        for seed in group:
            t0 = time.perf_counter()
            cell = harness.make_cell(bench, BENCH_DIR, a.workload, seed, dev,
                                     spans)
            drv = harness.make_driver(cell, BENCH_DIR)
            if kind == "program":
                drv.setup()
                win = drv.window(a.seconds)
                drv.release()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                numbers = drv.check()
                extra = {"maps": len(win.latencies_s),
                         "checked": drv.checked}
            elif kind == "control":
                drv.prepare()
                numbers = drv.control(CONTROL_DTYPE)
                extra = {}
            else:
                if not hasattr(drv, "order_control"):
                    p.error(f"{a.workload}'s driver has no order control")
                drv.prepare()
                numbers = drv.order_control()
                extra = {}
            print(json.dumps({"workload": a.workload, "kind": kind,
                              "seed": seed, **numbers, **extra,
                              "s": round(time.perf_counter() - t0, 2)}),
                  flush=True)
            del drv
    return 0


if __name__ == "__main__":
    sys.exit(main())
