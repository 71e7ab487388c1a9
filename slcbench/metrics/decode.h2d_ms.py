"""Mean ms per scan of the pattern stack's copy to the device, as
``run_replay``'s ``to_dev`` makes it, ended by a sync."""

from slcbench.metric_lib import span_mean_ms


def read(run):
    return span_mean_ms(run, "decode.h2d")
