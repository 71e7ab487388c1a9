"""``device.idle_pct`` in the tracked cell, where it moves ``map_p50_ms``:
the traced window's share with no kernel, copy or memset on the card."""

from slcbench.metric_lib import idle_pct


def read(run):
    return idle_pct(run)
