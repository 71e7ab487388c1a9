"""Mean ms of the staging host function's memcpy of a frame into pinned
memory (``kernels/csrc/staging.cu``): the program's counters
``stage.copy_ns`` over ``stage.jobs``, timed in C for the copies queued
in the traced window."""

from slcbench.program_spans import ratio_ms


def read(run):
    return ratio_ms(run, "stage.copy_ns", "stage.jobs")
