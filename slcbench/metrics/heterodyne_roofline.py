"""The heterodyne decode's share of its roofline
(``slc_tpu_torch/kernels/csrc/heterodyne.cu``, one launch a decode).

Bytes a decode needs: F x N u8 fringe planes in, four float32 maps (x,
y, z, P) out: 28 B/px at 3 frequencies x 4 steps."""

from slcbench.metric_lib import pixels, roofline_pct

KERNELS = ("heterodyne_kernel",)


def bytes_per_px(config: dict) -> int:
    h = config["heterodyne"]
    return len(h["fringe_counts"]) * h["phase_steps"] + 4 * 4


def read(run):
    return roofline_pct(run, KERNELS, KERNELS[0],
                        bytes_per_px(run.config) * pixels(run))
