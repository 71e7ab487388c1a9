"""Share of the registration's point-to-plane Gauss-Newton steps that ran
as the hand-written kernels (slc_tpu_torch/kernels/p2l.py): the program's
counter ``fusion.p2l_kernel`` over ``fusion.gn_steps``. 1.0 where every
step was the kernels, 0 where the plain steps ran; nothing to read where
the program keeps no such counter."""

from slcbench.program_spans import counters


def read(run):
    c = counters(run) or {}
    steps = c.get("fusion.gn_steps", 0)
    if not steps or "fusion.p2l_kernel" not in c:
        return None
    return c["fusion.p2l_kernel"] / steps
