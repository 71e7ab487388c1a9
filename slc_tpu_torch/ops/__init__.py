"""Dense per-pixel ops: the plain PyTorch versions of slc_tpu.ops, the
semantics every kernel is held to."""
