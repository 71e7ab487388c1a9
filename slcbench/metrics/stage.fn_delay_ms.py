"""Mean ms from the enqueue of a frame's staging host function
(``kernels/csrc/staging.cu``) to its start on CUDA's callback thread:
the program's counters ``stage.fn_delay_ns`` over ``stage.jobs``, timed
in C for the copies queued in the traced window. On the CPU the copy
starts at once, and it reads 0."""

from slcbench.program_spans import ratio_ms


def read(run):
    return ratio_ms(run, "stage.fn_delay_ns", "stage.jobs")
