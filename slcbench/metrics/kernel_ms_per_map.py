"""Device milliseconds of kernels per map: every kernel the card ran in
the window (the locked steps, and each sequence's decode, lock window,
period and tracker start), over the maps the window delivered. Copies
are left out: a pageable copy's time on the card follows the shared
host's memory copies, as the host loop's rate follows its speed
(PERF.md section 2)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or not run.latencies_s:
        return None
    return 1e3 * sum(t for _, t in tr.kernels.values()) / len(
        run.latencies_s)
