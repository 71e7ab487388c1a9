"""``stream.fetch_wait_ms`` in the tracked cell, where it moves
``map_p50_ms``: the program's span ``stream.fetch_wait`` over its
``stream.fetch`` calls, in ms."""

from slcbench.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "stream.fetch_wait", "stream.fetch", "total_ns")
