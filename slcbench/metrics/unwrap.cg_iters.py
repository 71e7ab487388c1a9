"""Mean CG iterations per spatial unwrap: the program's counters
``unwrap.cg_iters`` over ``unwrap.calls``."""

from slcbench.program_spans import counters


def read(run):
    c = counters(run) or {}
    return c["unwrap.cg_iters"] / c["unwrap.calls"] \
        if c.get("unwrap.calls") else None
