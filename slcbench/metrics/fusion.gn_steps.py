"""Point-to-plane Gauss-Newton steps per registration: the program's
counters ``fusion.gn_steps`` over ``fusion.calls`` (rounds x gn_iters, 40
at the sweep configuration's settings; fewer is dropped work)."""

from slcbench.program_spans import counters


def read(run):
    c = counters(run) or {}
    return c.get("fusion.gn_steps", 0) / c["fusion.calls"] \
        if c.get("fusion.calls") else None
