"""Mean host ms per spatial map spent in the unwrap's residual
read-backs: the program's span ``unwrap.wait`` (one a CG iteration, each
a wait on the device) over its ``decode.spatial`` calls."""

from slcbench.program_spans import per_call_ms


def read(run):
    return per_call_ms(run, "unwrap.wait", "decode.spatial", "total_ns")
