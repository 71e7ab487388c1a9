"""Mean host ms per sequence of ``ops.demod.suggest_lock_window`` (numpy
over the frame-0 projector map on the host), from the program's span
``setup.lock_window``."""

from slcbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "setup.lock_window")
