"""Host-to-device staging of camera frames (csrc/staging.cu).

Source note. Not a port of a TPU kernel: the counterpart of
``jax.device_put``, which queues a transfer and returns. One call queues,
on the current stream of the destination's device, a host function that
copies the host parts into a pinned buffer (on CUDA's callback thread,
no Python lock held) and the pinned buffer's copy to the device. Bound by
the host's memory copy and the PCIe link, not by the card; what it saves
is the caller's thread, which only enqueues. The stream owns the order:
the caller keeps the host parts alive until an event recorded after the
call has completed (:class:`slc_tpu_torch.streaming.HostStager` does).

While the program's spans record (a profiler runs, see
:mod:`slc_tpu_torch.metrics`), a call is timed: the host function
measures its start delay and its memcpy (``stage.*`` in
``metrics.counters()``).

There is no plain version: on the CPU a frame is a tensor already, and
the stager takes a CPU tensor's path without calling this.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from slc_tpu_torch import metrics
from slc_tpu_torch.kernels import _build


def stage_h2d(parts: Sequence[np.ndarray], pinned: torch.Tensor,
              dev: torch.Tensor) -> None:
    """Queue the copy of ``parts`` (C-contiguous host arrays of one shape
    and type, kept alive by the caller until the copy completes) into the
    pinned CPU tensor ``pinned``, then of ``pinned`` into the CUDA tensor
    ``dev``, on ``dev``'s device's current stream. ``pinned`` and ``dev``
    hold exactly the parts, stacked."""
    if not parts:
        raise ValueError("stage_h2d: no parts to copy")
    part_bytes = parts[0].nbytes
    if any(not p.flags.c_contiguous or p.nbytes != part_bytes
           for p in parts):
        raise ValueError("stage_h2d: the parts must be C-contiguous and "
                         "of one size")
    total = part_bytes * len(parts)
    if dev.device.type != "cuda":
        raise ValueError(f"stage_h2d: the destination must be a cuda "
                         f"tensor, got one on {dev.device}")
    if pinned.device.type != "cpu" or not pinned.is_pinned():
        raise ValueError("stage_h2d: the staging buffer must be pinned host "
                         "memory")
    for name, t in (("pinned", pinned), ("dev", dev)):
        if not t.is_contiguous() or t.numel() * t.element_size() != total:
            raise ValueError(f"stage_h2d: {name} must be contiguous and "
                             f"hold {total} bytes")
    src = (ctypes.c_void_p * len(parts))(*(p.ctypes.data for p in parts))
    timed = metrics.recording()
    _build.launch("slc_stage_h2d", dev.device, src, len(parts), part_bytes,
                  pinned.data_ptr(), dev.data_ptr(), int(timed))
    stage_h2d.launches += 1


stage_h2d.launches = 0
