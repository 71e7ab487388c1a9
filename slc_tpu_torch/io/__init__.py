"""Host I/O: calibration files, the BMP codec, dataset replay, and the
native library (``io/native``: the C++ BMP codec, the threaded frame
loader and the XYZ writer, built from source at first use) that the codec,
the replay and the cloud writer go through, as slc_tpu.io does."""

from slc_tpu_torch.io.opencv_yaml import (load_opencv_yaml, save_opencv_yaml,
                                          load_calibration, save_calibration)
from slc_tpu_torch.io.bmp import read_bmp, write_bmp
from slc_tpu_torch.io.dataset import ReplayDataset, write_replay_dataset

__all__ = [
    "load_opencv_yaml", "save_opencv_yaml",
    "load_calibration", "save_calibration",
    "read_bmp", "write_bmp",
    "ReplayDataset", "write_replay_dataset",
]
