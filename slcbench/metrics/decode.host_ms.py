"""Mean host ms per ``pipeline.decode_first_frame`` or
``decode_heterodyne_frame`` call, from the program's span
``decode.first`` (the wrapper's checks, buffers and launch; no sync)."""

from slcbench.program_spans import mean_ms


def read(run):
    return mean_ms(run, "decode.first")
