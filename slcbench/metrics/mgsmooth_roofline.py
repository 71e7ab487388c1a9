"""The multigrid level kernels' share of their roofline
(``slc_tpu_torch/kernels/csrc/mgsmooth.cu``: ``mg_down`` and ``mg_up`` on
each level of the spatial unwrap's preconditioner at least
``MG_KERNEL_MIN`` px on both sides).

Bytes a level needs, for its descent and its ascent: mg_down reads r,
wy, wx and dinv and writes e and r - A e; mg_up reads e, r, wy, wx and
dinv and writes e; float32, wy (h-1, w), wx (h, w-1). A preconditioner
call runs each level as many times as the K-cycle visits it (1, 2 and 4
at 1024x1280, 512x640 and 256x320). Calls are counted from the descent
launches, at that many a call."""

KERNELS = ("mg_down_kernel", "mg_down_small_kernel", "mg_up_kernel")
#: The preconditioner's shape (``ops/unwrap_spatial.py``): coarsening
#: stops at 32 px; the first two coarse levels take a K-cycle (two
#: visits of the level below); the kernels run on levels >= 256 px.
COARSEST = 32
KDEPTH = 2
KERNEL_MIN = 256


def kernel_levels(h: int, w: int):
    """[(h, w, visits a call)] of the levels the kernels run on."""
    sizes = [(h, w)]
    while min(sizes[-1]) > COARSEST:
        lh, lw = sizes[-1]
        sizes.append((-(-lh // 2), -(-lw // 2)))
    out, visits = [], 1
    for i, (lh, lw) in enumerate(sizes[:-1]):        # the coarsest is Jacobi
        if min(lh, lw) >= KERNEL_MIN:
            out.append((lh, lw, visits))
        if KDEPTH - i > 0 and len(sizes) - i > 2:
            visits *= 2
    return out


def level_bytes(h: int, w: int) -> int:
    edges = (h - 1) * w + h * (w - 1)
    return 4 * ((4 * h * w + edges) + (4 * h * w + edges))


def read(run):
    s = run.config["system"]
    levels = kernel_levels(s["cam_h"], s["cam_w"])
    if not levels or run.trace is None:
        return None
    launches = sum(v for _, _, v in levels)
    per_call = sum(v * level_bytes(h, w) for h, w, v in levels)
    calls = sum(run.trace.kernels.get(k, (0, 0.0))[0]
                for k in KERNELS[:2]) / launches
    if not calls:
        return None
    t = sum(run.trace.kernels[k][1] for k in KERNELS
            if k in run.trace.kernels)
    if t <= 0 or run.hbm_bytes_per_s is None:
        return None
    return 100.0 * calls * per_call / run.hbm_bytes_per_s / t
