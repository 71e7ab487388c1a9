"""Maps on the host per second of the traced window, the tracked cell's
rate with the harness's spans and the profiler on: every map and the
window's whole wall time. Untraced runs keep it out of the end-to-end
metrics, where the shared host's speed spreads it wider than any bound
(PERF.md section 2)."""


def read(run):
    if not run.latencies_s or not run.wall_s:
        return None
    return len(run.latencies_s) / run.wall_s
