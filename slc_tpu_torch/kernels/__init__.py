"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions.

Each module holds one kernel's wrapper (``*_cuda``, with a ``launches``
count), its plain version (``*_ref``) and the public function that
dispatches on the device: CPU tensors take the plain version, CUDA
tensors the kernel. Two entries are no TPU kernel's port:
:mod:`~slc_tpu_torch.kernels.staging`, the frame stager's host-to-device
copy, queued on a stream, and :mod:`~slc_tpu_torch.kernels.lock_window`,
the median of the frame-0 map's gradient, which slc_tpu takes with numpy
on the host. The CUDA sources live in ``csrc/`` and are
built by :mod:`slc_tpu_torch.kernels._build` at first use.
"""
