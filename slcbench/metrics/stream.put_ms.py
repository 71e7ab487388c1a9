"""Mean host ms per ``streaming.HostStager.put`` call (the next frame's
copy enqueued one frame ahead), the span ended by a sync of the current
stream."""

from slcbench.metric_lib import span_mean_ms


def read(run):
    return span_mean_ms(run, "stream.put")
