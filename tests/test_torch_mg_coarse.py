"""The K-cycle's coarsest level on the CPU: the routing rule that sends
a coarsest level on a CUDA tensor to ``kernels.mgsmooth.mg_coarse``
(a function of its shape alone), the plain version bit for bit against
the lines ``vcycle`` ran inline before the kernel existed, the CPU's
dispatch to the plain version whatever the shape, and the counters
``unwrap.coarse_visits`` and ``unwrap.coarse_kernel`` of the eager CG
loop. The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slc_tpu_torch import metrics
from slc_tpu_torch.kernels import mgsmooth
from slc_tpu_torch.ops import unwrap_spatial as U

torch.set_num_threads(2)

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def clean():
    metrics.reset()
    yield
    metrics.reset()


def _level(h, w, seed=0, zero_row=None):
    """A random O(1) level (r, wy, wx, dinv): quality in [0.1, 1], and
    with ``zero_row`` that row's edges weighted 0."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.uniform(0.1, 1.0, (h, w)).astype(np.float32))
    wy, wx = U.edge_weights(q)
    if zero_row is not None:
        wy[zero_row] = 0.0
        wx[zero_row] = 0.0
    dinv = 1.0 / U._diag(wy, wx)
    r = torch.from_numpy(rng.normal(0, 1, (h, w)).astype(np.float32))
    return r, wy, wx, dinv


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("shape,fits", [
    ((32, 40), True), ((24, 40), True), ((17, 29), True), ((1, 1), True),
    ((64, 128), True), ((1, 8192), True), ((8192, 1), True),
    ((64, 129), False), ((1, 8193), False), ((91, 91), False),
    ((1024, 1280), False)])
def test_the_routing_rule_is_the_shape(shape, fits):
    """At most MG_COARSE_KERNEL_MAX pixels, whatever the sides: the level
    and its two e buffers, 24 B a pixel, in one block's shared memory
    (227 KiB on an H100)."""
    assert U.coarse_kernel_fits(*shape) is fits
    assert 24 * U.MG_COARSE_KERNEL_MAX <= 227 * 1024


def _parents_coarse_lines(r, levels, omega=U.MG_OMEGA,
                          coarse_sweeps=U.MG_COARSE_SWEEPS):
    """A frozen copy of vcycle's coarsest-level branch as it was before
    the kernel, its matvec written out."""
    wy, wx, dinv, _ = levels[0]

    def scatter(dy, dx):
        return ((F.pad(dy, (0, 0, 1, 0)) - F.pad(dy, (0, 0, 0, 1)))
                + F.pad(dx, (1, 0))) - F.pad(dx, (0, 1))

    def matvec(p):
        return scatter(wy * (p[1:, :] - p[:-1, :]),
                       wx * (p[:, 1:] - p[:, :-1]))
    e = omega * dinv * r
    for _ in range(coarse_sweeps - 1):
        e = e + omega * dinv * (r - matvec(e))
    return e


@pytest.mark.parametrize("shape,zero_row", [((32, 40), None),
                                            ((17, 29), 5),
                                            ((1, 32), None)])
def test_mg_coarse_ref_is_the_parents_lines(shape, zero_row):
    """The plain version, the CPU's route and vcycle's, bit for bit."""
    h, w = shape
    r, wy, wx, dinv = _level(h, w, seed=3, zero_row=zero_row)
    want = _parents_coarse_lines(r, [(wy, wx, dinv, shape)])
    for got in (mgsmooth.mg_coarse_ref(r, wy, wx, dinv),
                mgsmooth.mg_coarse(r, wy, wx, dinv),
                U.vcycle(r, [(wy, wx, dinv, shape)])):
        assert torch.equal(_bits(got), _bits(want))


def test_the_kernel_takes_cuda_tensors_only():
    r, wy, wx, dinv = _level(32, 40)
    with pytest.raises(ValueError, match="cuda"):
        mgsmooth.mg_coarse_cuda(r, wy, wx, dinv)
    meta = torch.empty((8, 8), device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        mgsmooth.mg_coarse(meta, meta[1:], meta[:, 1:], meta)


@pytest.mark.parametrize("shape", [(32, 40), (64, 129)])
def test_vcycle_routes_the_coarsest_level_by_its_shape(monkeypatch, shape):
    """A level the rule admits goes to mg_coarse (on the CPU its plain
    version), a larger one to mg_coarse_ref; each is one coarsest
    visit, with the sweeps and omega vcycle was given."""
    calls, ref = [], mgsmooth.mg_coarse_ref
    for name in ("mg_coarse", "mg_coarse_ref"):
        def rec(*a, name=name):
            calls.append((name, a[4:]))
            return ref(*a)
        monkeypatch.setattr(mgsmooth, name, rec)
    r, wy, wx, dinv = _level(*shape)
    before = U.vcycle.coarse_visits
    U.vcycle(r, [(wy, wx, dinv, shape)], omega=0.8, coarse_sweeps=5)
    assert U.vcycle.coarse_visits == before + 1
    want = "mg_coarse" if U.coarse_kernel_fits(*shape) else "mg_coarse_ref"
    assert calls == [(want, (0.8, 5))]


def test_the_eager_loop_counts_the_coarsest_visits():
    """Under a profiler the eager CG loop at 256x320 (levels down to
    32x40, the K-cycle visiting the coarsest 4 times a preconditioner
    call) counts 4 x (1 + cg_iters) coarsest visits, none of them a
    kernel launch on the CPU; without a profiler it counts nothing."""
    h, w, t = 256, 320, 32.0
    rng = np.random.default_rng(5)
    x = (np.linspace(0, 4 * t, w)[None, :]
         + 0.3 * np.arange(h)[:, None]).astype(np.float32)
    psi = torch.from_numpy(np.mod(x + rng.normal(0, 0.05, (h, w)), t)
                           .astype(np.float32))
    anchor = torch.from_numpy(x + rng.uniform(-t / 3, t / 3, (h, w))
                              .astype(np.float32))
    U.unwrap_spatial(psi, t, anchor=anchor, max_iters=3)
    assert metrics.counters() == {}
    with torch.profiler.profile(activities=CPU):
        _, info = U.unwrap_spatial(psi, t, anchor=anchor, return_info=True)
    c = metrics.counters()
    assert info["cg_iters"] >= 1
    assert c["unwrap.coarse_visits"] == 4 * (1 + info["cg_iters"])
    assert c["unwrap.coarse_kernel"] == 0
