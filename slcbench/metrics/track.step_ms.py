"""Mean host ms per ``dynamic.dynamic_step`` call (the locked step with its
kernel wrappers), ended by a sync of the current stream."""

from slcbench.metric_lib import span_mean_ms


def read(run):
    return span_mean_ms(run, "track.step")
