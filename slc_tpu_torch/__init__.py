"""slc_tpu_torch — the structured-light depth engine of slc_tpu, ported to
PyTorch with hand-written CUDA kernels for one NVIDIA H100.

The JAX package ``slc_tpu`` is the reference; this package imports
neither it nor ``jax``. Module names follow slc_tpu's, so each module's
counterpart is found by name. Functions take tensors and an explicit
device; kernels live in :mod:`slc_tpu_torch.kernels`.
"""

from slc_tpu_torch.config import SystemConfig, REFERENCE_CONFIG
from slc_tpu_torch.calib import Calibration, TriangulationTables

__all__ = [
    "SystemConfig",
    "REFERENCE_CONFIG",
    "Calibration",
    "TriangulationTables",
]
