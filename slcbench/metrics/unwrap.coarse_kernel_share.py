"""Share of the spatial unwrap's coarsest-level visits that ran as one
launch of the hand-written coarse kernel: the program's counter
``unwrap.coarse_kernel`` over ``unwrap.coarse_visits``. 1.0 where every
visit was the kernel, 0 where the plain sweeps ran; nothing to read
where the program keeps no such counter."""

from slcbench.program_spans import counters


def read(run):
    c = counters(run) or {}
    visits = c.get("unwrap.coarse_visits", 0)
    if not visits or "unwrap.coarse_kernel" not in c:
        return None
    return c["unwrap.coarse_kernel"] / visits
