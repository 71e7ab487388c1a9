"""``stream.fetch_ms`` in the tracked cell, where it moves ``map_p50_ms``:
mean ms per map from ``streaming.fetch_z_async`` until z is on the host."""

from slcbench.metric_lib import span_mean_ms


def read(run):
    return span_mean_ms(run, "stream.fetch")
