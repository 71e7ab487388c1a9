"""Host I/O: calibration files, the BMP codec, dataset replay, and the
native library (``io/native``: the C++ BMP codec, the threaded frame
loader and the XYZ writer, built from source at first use) that the codec,
the replay and the cloud writer go through, as slc_tpu.io does."""
