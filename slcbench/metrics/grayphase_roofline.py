"""The Gray + phase decode's share of its roofline
(``slc_tpu_torch/kernels/csrc/grayphase.cu``, one launch a decode).

Bytes a decode needs: 2B Gray and N phase u8 planes in, four float32
maps (x, y, z, P) out: 32 B/px at 6 bits and 4 steps."""

from slcbench.metric_lib import pixels, roofline_pct

KERNELS = ("grayphase_kernel",)


def bytes_per_px(system: dict) -> int:
    return 2 * system["gray_bits"] + system["phase_steps"] + 4 * 4


def read(run):
    return roofline_pct(run, KERNELS, KERNELS[0],
                        bytes_per_px(run.config["system"]) * pixels(run))
