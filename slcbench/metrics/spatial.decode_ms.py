"""Mean ms per spatial map of ``pipeline.decode_spatial_frame`` (the
harness span ``spatial.run``), ended by a sync of the current stream:
the decode's host work and its device work together."""

from slcbench.metric_lib import span_mean_ms


def read(run):
    return span_mean_ms(run, "spatial.run")
