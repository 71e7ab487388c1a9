"""The locked tracker step's share of its roofline
(``slc_tpu_torch/kernels/csrc/dynamic_step.cu``: four launches a step).

Bytes a step needs: the u8 frame and three carried float32 maps (P and
the two strips) in, six float32 maps (P, strips, z, x, y) out: 37 B/px.
The lock moves no state of its own."""

from slcbench.metric_lib import pixels, roofline_pct

KERNELS = ("track_kernel", "lock_dc_kernel", "lock_corr_kernel",
           "snap_kernel")
#: One launch per locked step.
CALL_KERNEL = "snap_kernel"
BYTES_PER_PX = 1 + 3 * 4 + 6 * 4


def read(run):
    return roofline_pct(run, KERNELS, CALL_KERNEL,
                        BYTES_PER_PX * pixels(run))
