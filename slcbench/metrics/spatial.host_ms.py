"""Mean host ms per ``pipeline.decode_spatial_frame`` call, from the
program's span ``decode.spatial`` (no sync of its own: the unwrap's
per-iteration read-backs, ``unwrap.wait``, are inside it)."""

from slcbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "decode.spatial")
