"""Mean ms per sweep of ``fusion_frontend.register_scans`` and the read of
its poses to the host (the harness's span ``fuse.register``, ended by a
sync of the current stream)."""

from slcbench.metric_lib import span_mean_ms


def read(run):
    return span_mean_ms(run, "fuse.register")
