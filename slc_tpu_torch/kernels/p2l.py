"""One point-to-plane Gauss-Newton step over the poses of a multi-view
registration as hand-written CUDA (``csrc/p2l.cu``): a statistics pass, a
normal-equation pass and a solve-and-update kernel, three launches a step
with no host synchronisation and no library kernel.

Source note. Replaces no TPU kernel: slc_tpu runs the step as XLA einsums
and a batched solve (slc_tpu/fusion.py:173-243), and the port ran it as
plain PyTorch, ~100 launches a step, among them a cuBLAS GEMM for the
(S, 6, 6) product j^T j over the L landmarks of each view (N = 6: one
32x32 tile a view, ~16 blocks on 132 SMs). Here the pose Jacobian j never
reaches device memory: the second pass builds it in registers and sums
the 21 distinct entries of each view's symmetric j j^T and the 6 of its
right-hand side. Both passes read obs and mask (16 B a pair) and the
landmarks and normals (24 B a landmark), ~46 MB a step at S = 16 and
L = 81,920, and are bound by those bytes. Every sum is taken in one fixed
order, so a step is bit-for-bit repeatable; it reorders the plain step's
float32 sums, so the two agree to float32 rounding, not bit for bit.

The arithmetic is ``fusion._gn_step_p2l``'s (its plain version, kept
there for the CPU and for shard reductions). :func:`gn_step_p2l_cuda`
takes CUDA float32 tensors and raises on anything else.
"""

from __future__ import annotations

from typing import Tuple

import torch

from slc_tpu_torch import metrics
from slc_tpu_torch.kernels import _build

#: Threads a block of the two passes (csrc/p2l.cu kThreads).
THREADS = 256
#: Blocks a view is given for each SM of the card, divided among the
#: views: about two resident blocks an SM in all.
BLOCKS_PER_SM = 2
#: Floats of one block's partials in pass 1 (sum p m, sum m, sum |e|) and
#: pass 2 (21 of j j^T, 6 of j e).
STATS, TERMS = 5, 27
#: Kernel launches a step.
LAUNCHES_PER_STEP = 3


def blocks_per_view(views: int, landmarks: int, sms: int) -> int:
    """Blocks a view in passes 1 and 2: BLOCKS_PER_SM * sms shared among
    the views, and no more than the view's landmarks fill."""
    fill = -(-landmarks // THREADS)
    return max(1, min(-(-BLOCKS_PER_SM * sms // views), fill))


class P2LWork:
    """What the kernel step needs beside its inputs, for S views of L
    landmarks on one card, allocated once (``fusion._fuse_scans_p2l``
    makes one a call): the blocks' partial sums of both passes, the
    views' centroids, the poses each step writes (``rot`` (S, 3, 3) and
    ``trans`` (S, 3)), and ``info``, the int64 sum of the solves' failure
    codes over every step that used it."""

    def __init__(self, views: int, landmarks: int, device):
        device = torch.device(device)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.views, self.landmarks = views, landmarks
        self.blocks = blocks_per_view(views, landmarks, sms)
        f32 = dict(dtype=torch.float32, device=device)
        self.part1 = torch.empty(views * self.blocks * STATS, **f32)
        self.part2 = torch.empty(views * self.blocks * TERMS, **f32)
        self.center = torch.empty(views, 3, **f32)
        self.rot = torch.empty(views, 3, 3, **f32)
        self.trans = torch.empty(views, 3, **f32)
        self.info = torch.zeros((), dtype=torch.int64, device=device)


def gn_step_p2l_cuda(rot: torch.Tensor, trans: torch.Tensor,
                     landmarks: torch.Tensor, normals: torch.Tensor,
                     obs: torch.Tensor, mask: torch.Tensor, damping: float,
                     work: P2LWork) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: ``rot`` (S, 3, 3), ``trans`` (S, 3), ``landmarks`` and
    ``normals`` (L, 3), ``obs`` (S, L, 3), ``mask`` (S, L), contiguous
    float32 on one CUDA device, and a :class:`P2LWork` of that shape
    there. Writes the new poses into ``work.rot`` and ``work.trans``
    (``rot`` and ``trans`` may be those buffers) and adds the step's
    summed solve codes to ``work.info``; returns (work.rot, work.trans).
    The host work before the launches is the span ``kernel.prep``."""
    with metrics.span("kernel.prep"):
        if mask.ndim != 2 or mask.numel() == 0:
            raise ValueError(f"mask: expected a non-empty (S, L) tensor, got "
                             f"{tuple(mask.shape)}")
        s, l = mask.shape
        dev = mask.device
        f32 = torch.float32
        for t, name, shape in ((obs, "obs", (s, l, 3)), (mask, "mask", (s, l)),
                               (landmarks, "landmarks", (l, 3)),
                               (normals, "normals", (l, 3)),
                               (rot, "rot", (s, 3, 3)),
                               (trans, "trans", (s, 3))):
            _build.require(t, name, f32, shape, dev)
        if (work.views, work.landmarks) != (s, l) or work.rot.device != dev:
            raise ValueError(f"work: made for {work.views} views of "
                             f"{work.landmarks} landmarks on "
                             f"{work.rot.device}, given ({s}, {l}) on {dev}")
    _build.launch("slc_p2l_step", dev, obs.data_ptr(), mask.data_ptr(),
                  landmarks.data_ptr(), normals.data_ptr(), rot.data_ptr(),
                  trans.data_ptr(), work.rot.data_ptr(),
                  work.trans.data_ptr(), work.part1.data_ptr(),
                  work.part2.data_ptr(), work.center.data_ptr(),
                  work.info.data_ptr(), s, l, work.blocks, float(damping))
    gn_step_p2l_cuda.launches += LAUNCHES_PER_STEP
    return work.rot, work.trans


gn_step_p2l_cuda.launches = 0
