"""Share of the spatial unwrap's CG starts and iterations that ran as
CUDA graph replays: the program's counter ``unwrap.graph_replays`` over
``unwrap.calls`` + ``unwrap.cg_iters`` (one start a call, one replay an
iteration). 1.0 where every one was a replay; nothing to read where the
program keeps no such counter."""

from slcbench.program_spans import counters


def read(run):
    c = counters(run) or {}
    runs = c.get("unwrap.calls", 0) + c.get("unwrap.cg_iters", 0)
    if not runs or "unwrap.graph_replays" not in c:
        return None
    return c["unwrap.graph_replays"] / runs
