"""Run one cell of the benchmark of ``slc_tpu_torch`` once.

    python3 slcbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program. It renders the cell's scenes from the seed, warms up,
drives the program for ``--seconds``, checks what the window produced
against the plain reference in ``slcbench/reference/`` and prints one
JSON line last on standard output. With ``--trace 1`` the metrics are
the cell's per-layer metrics, read from spans and ``torch.profiler``.
It exits non-zero, printing no result, without a CUDA card, or if a
module of the JAX stack or ``slc_tpu`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Caches at fixed paths inside the checkout; the program's own kernel
# build lives in slc_tpu_torch/kernels/build/.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
    ROOT, ".slcbench_cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".slcbench_cache",
                                              "triton")
os.environ.setdefault("OMP_NUM_THREADS", "1")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from slcbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    chips = cells[args.workload]["chips"] if args.workload in cells else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"the cell needs {chips} CUDA card(s); this machine "
                    f"has {n}")
        return 2
    torch.set_num_threads(1)
    out = harness.run_cell(bench, BENCH_DIR, args.workload, args.seed,
                           args.seconds, bool(args.trace), "cuda:0",
                           T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
