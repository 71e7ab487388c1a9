"""Mean host ms per ``streaming.HostStager.put`` call, from the program's
span ``stream.put`` (the enqueue of the next frame's copy, with the wait
for a free ring buffer, ``stream.ring_wait``, inside it; no sync)."""

from slcbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "stream.put")
