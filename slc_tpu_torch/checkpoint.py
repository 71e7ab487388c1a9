"""Tracker-state checkpoint / resume (PyTorch port of the npz path of
slc_tpu/checkpoint.py).

The carried state is tiny and explicit (TrackerState: P, stripW, stripB,
z, frame_idx), so any frame is a resume point. Checkpoints are npz files
with slc_tpu's field names (checkpoint.py:29), written through an atomic
rename: an npz checkpoint either package wrote resumes in the other.
slc_tpu writes npz only without orbax; with orbax it writes a directory
(OCDBT), which the port does not read (that needs orbax or tensorstore):
:func:`load_state` raises a ValueError naming it.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from slc_tpu_torch.dynamic import TrackerState

_FIELDS = ("proj_u", "strip_w", "strip_b", "z", "frame_idx")
#: Files by which an orbax checkpoint directory is recognised.
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def save_state(path: str, state: TrackerState) -> str:
    """Save a TrackerState to ``path`` (an .npz suffix is added);
    returns the path written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp.npz"
    np.savez(tmp, **state.to_numpy())
    os.replace(tmp, path)
    return path


def load_state(path: str, device="cuda") -> TrackerState:
    """The TrackerState saved at ``path``, on the card unless ``device``
    says otherwise (a CUDA device without CUDA raises)."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    if os.path.isdir(path) and any(
            os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path} is an orbax checkpoint, which slc_tpu_torch cannot "
            f"read: write npz checkpoints with slc_tpu (orbax not "
            f"installed, or slc_tpu.checkpoint._HAVE_ORBAX = False)")
    with np.load(path) as f:
        return TrackerState.from_numpy({k: f[k] for k in _FIELDS}, device)


def latest_checkpoint(ckpt_dir: str, prefix: str = "frame_"
                      ) -> Optional[str]:
    """Find the newest ``<prefix><N>`` checkpoint under ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_n = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(rf"{re.escape(prefix)}(\d+)(?:\.npz)?", name)
        if m and int(m.group(1)) > best_n:
            best, best_n = os.path.join(ckpt_dir, name), int(m.group(1))
    return best
