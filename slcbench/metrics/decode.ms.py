"""Mean ms per scan of the configuration's ``pipeline.decode_*`` call, ended
by a sync of the current stream."""

from slcbench.metric_lib import span_mean_ms


def read(run):
    return span_mean_ms(run, "decode.run")
