"""Mean ms per sequence of the tracker's set-up: the frame-0 stack's copy,
the decode, map 0 to the host, ``suggest_lock_window``,
``estimate_period`` and ``init_tracker``, ended by a sync."""

from slcbench.metric_lib import span_mean_ms


def read(run):
    return span_mean_ms(run, "track.seq_setup")
