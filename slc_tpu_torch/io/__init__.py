"""Host I/O: calibration files, the BMP codec and dataset replay (numpy
copies of slc_tpu.io without its native C++ paths)."""
