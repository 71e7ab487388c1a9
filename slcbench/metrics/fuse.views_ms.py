"""Mean ms per sweep of its views' stack copies and Gray + phase decodes
(the harness's span ``fuse.views``, ended by a sync of the current
stream)."""

from slcbench.metric_lib import span_mean_ms


def read(run):
    return span_mean_ms(run, "fuse.views")
