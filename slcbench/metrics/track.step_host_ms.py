"""Mean host ms per ``dynamic.dynamic_step`` call, from the program's span
``track.step``: the wrapper's checks and buffers (``kernel.prep``) and
the launch (``kernel.launch``), with no sync. ``track.step_ms`` less this
is the wait on the step's kernels."""

from slcbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "track.step")
