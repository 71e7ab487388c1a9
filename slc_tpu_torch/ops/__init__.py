"""Dense per-pixel ops: the plain PyTorch versions of slc_tpu.ops, the
semantics every kernel is held to. The names below are slc_tpu.ops's;
``stripe_regression`` and ``bilateral_filter`` here are the plain
versions (the dispatching ones, which take the kernels on the card, are
in :mod:`slc_tpu_torch.kernels`)."""

from slc_tpu_torch.ops.phase import decode_phase, phase_sincos, modulation
from slc_tpu_torch.ops.gray import decode_gray, gray_to_binary, binary_to_gray
from slc_tpu_torch.ops.unwrap import gray_assisted_merge, heterodyne_unwrap
from slc_tpu_torch.ops.triangulate import triangulate_depth, backproject
from slc_tpu_torch.ops.stripe import stripe_regression, box_sum_vertical
from slc_tpu_torch.ops.filters import box_blur_3x3, bilateral_filter

__all__ = [
    "decode_phase", "phase_sincos", "modulation",
    "decode_gray", "gray_to_binary", "binary_to_gray",
    "gray_assisted_merge", "heterodyne_unwrap",
    "triangulate_depth", "backproject",
    "stripe_regression", "box_sum_vertical",
    "box_blur_3x3", "bilateral_filter",
]
