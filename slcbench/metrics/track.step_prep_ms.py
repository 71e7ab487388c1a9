"""Host ms per tracker step of the kernel wrappers' preparation (the
program's span ``kernel.prep``, self time: input checks, output maps,
``lock_buffers``, ``tri_array``) over the ``track.step`` calls. The Gray
decode of each sequence's frame 0 prepares its kernel too, one call in
100 frames. On the CPU no kernel is prepared, and it reads 0."""

from slcbench.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "kernel.prep", "track.step", "self_ns")
