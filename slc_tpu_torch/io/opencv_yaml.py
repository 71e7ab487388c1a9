"""OpenCV FileStorage YAML parser/writer for calibration files.

The reference loads ``CamMat / ProMat / R / T`` with ``cv::FileStorage``
(DynaFrame/CCalculation.cpp:124-132); the on-disk schema is the
``%YAML:1.0`` + ``!!opencv-matrix`` format exemplified by
DynaFrame/Result.yml:1-28. This is a tiny dependency-free reader/writer
for exactly that dialect (PyYAML chokes on the ``%YAML:1.0`` directive
line and the custom tag, so we parse it directly).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np


def load_opencv_yaml(path: str) -> Dict[str, np.ndarray]:
    """Parse an OpenCV-YAML file into {name: float64 array (rows, cols)}."""
    with open(path) as f:
        text = f.read()
    out: Dict[str, np.ndarray] = {}
    # Each entry: 'Name: !!opencv-matrix' then indented rows/cols/dt/data.
    pattern = re.compile(
        r"^(\w+):\s*!!opencv-matrix\s*$"
        r"(.*?)(?=^\w+:|\Z)", re.M | re.S)
    for m in pattern.finditer(text):
        name, body = m.group(1), m.group(2)
        rows = int(re.search(r"rows:\s*(\d+)", body).group(1))
        cols = int(re.search(r"cols:\s*(\d+)", body).group(1))
        data = re.search(r"data:\s*\[(.*?)\]", body, re.S).group(1)
        vals = [float(v) for v in data.replace("\n", " ").split(",")]
        if len(vals) != rows * cols:
            raise ValueError(
                f"{path}: matrix {name} has {len(vals)} values, "
                f"expected {rows}x{cols}")
        out[name] = np.array(vals, np.float64).reshape(rows, cols)
    return out


def save_opencv_yaml(path: str, mats: Dict[str, np.ndarray]) -> None:
    """Write matrices in the reference's FileStorage dialect so files
    round-trip with OpenCV tooling."""
    lines = ["%YAML:1.0"]
    for name, mat in mats.items():
        a = np.asarray(mat, np.float64)
        if a.ndim == 1:
            a = a.reshape(-1, 1)
        lines.append(f"{name}: !!opencv-matrix")
        lines.append(f"   rows: {a.shape[0]}")
        lines.append(f"   cols: {a.shape[1]}")
        lines.append("   dt: d")
        vals = ", ".join(f"{v:.16e}" for v in a.ravel())
        lines.append(f"   data: [ {vals} ]")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_calibration(path: str):
    """Load a reference-schema calibration file into a Calibration
    (CamMat/ProMat/R/T, CCalculation.cpp:124-132)."""
    from slc_tpu_torch.calib import Calibration
    mats = load_opencv_yaml(path)
    missing = {"CamMat", "ProMat", "R", "T"} - set(mats)
    if missing:
        raise ValueError(f"{path}: missing calibration entries {missing}")
    return Calibration.from_numpy(mats["CamMat"], mats["ProMat"],
                                  mats["R"], mats["T"])


def save_calibration(path: str, calib) -> None:
    save_opencv_yaml(path, {
        "CamMat": np.asarray(calib.cam_k, np.float64),
        "ProMat": np.asarray(calib.pro_k, np.float64),
        "R": np.asarray(calib.rot, np.float64),
        "T": np.asarray(calib.trans, np.float64).reshape(3, 1),
    })
