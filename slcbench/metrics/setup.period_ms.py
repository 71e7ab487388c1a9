"""Mean host ms per sequence of ``ops.demod.estimate_period``'s enqueue,
from the program's span ``setup.period`` (the caller's ``float()`` of the
result, which waits for the device, is outside it)."""

from slcbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "setup.period")
