"""Mean host ms per fetched map spent waiting for z to reach the host:
the program's span ``stream.fetch_wait`` (``Fetched.z``'s event wait)
over its ``stream.fetch`` calls. On the CPU z is on the host already, and
the wait reads 0."""

from slcbench.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "stream.fetch_wait", "stream.fetch", "total_ns")
