"""Tracker-state checkpoint / resume (PyTorch port of the npz path of
slc_tpu/checkpoint.py).

The carried state is tiny and explicit (TrackerState: P, stripW, stripB,
z, frame_idx), so any frame is a resume point. Checkpoints are npz files
with slc_tpu's field names (checkpoint.py:29), written through an atomic
rename: an npz checkpoint either package wrote resumes in the other.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from slc_tpu_torch.dynamic import TrackerState

_FIELDS = ("proj_u", "strip_w", "strip_b", "z", "frame_idx")


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
