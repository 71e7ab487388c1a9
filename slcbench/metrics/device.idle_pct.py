"""Share of the traced window in which no kernel, copy or memset ran on
the card (the union of the profiler's device records)."""

from slcbench.metric_lib import idle_pct


def read(run):
    return idle_pct(run)
