"""Mean host ms per ``fusion_frontend.register_scans`` call, from the
program's span ``fusion.register`` (no sync of its own; the read-back of
the solves' failure codes at its end is inside it)."""

from slcbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "fusion.register")
