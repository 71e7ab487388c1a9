"""The hole-aware bilateral filter's share of its roofline
(``slc_tpu_torch/kernels/csrc/bilateral.cu``, one launch a spatial map).

Bytes a filter needs: z in and z out, float32: 8 B/px."""

from slcbench.metric_lib import pixels, roofline_pct

KERNELS = ("bilateral_kernel",)
BYTES_PER_PX = 2 * 4


def read(run):
    return roofline_pct(run, KERNELS, KERNELS[0], BYTES_PER_PX * pixels(run))
