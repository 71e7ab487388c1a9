"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions.

Each module holds one kernel's wrapper (``*_cuda``, with a ``launches``
count), its plain version (``*_ref``) and the public function that
dispatches on the device: CPU tensors take the plain version, CUDA
tensors the kernel. Three entries are no TPU kernel's port:
:mod:`~slc_tpu_torch.kernels.staging`, the frame stager's host-to-device
copy, queued on a stream; :mod:`~slc_tpu_torch.kernels.lock_window`,
the median of the frame-0 map's gradient, which slc_tpu takes with numpy
on the host; and :mod:`~slc_tpu_torch.kernels.p2l`, the registration's
point-to-plane Gauss-Newton step, whose plain version and dispatch stay
in ``fusion._gn_step_p2l``. The CUDA sources live in ``csrc/`` and are
built by :mod:`slc_tpu_torch.kernels._build` at first use.
"""
