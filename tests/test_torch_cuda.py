"""The CUDA kernels against their plain PyTorch versions on the card, at
the CPU tests' small shapes (96x160 and a ragged 90x150; the track
launch also at 1000x1270, the heterodyne decode at 97x157 and at 3 x 5
steps, the bilateral filter at 97x157, 1x1280 and 1024x1 and with 50%
holes, the multigrid kernels at 97x201 and at the level shapes of both
of chip_smoke.py's chains, the floors at widths 1270-1280; the coarsest
level's kernel bit for bit at the coarsest levels of 1024x1280 and
96x160, ragged, one-row, one-column, the largest the routing admits and
with a zero-weight row, and a level above the rule on the plain path;
the spatial unwrap's CG through its two CUDA graphs against the eager
loop, bit for bit, at 1024x1280, 1000x1270 and 96x160, with the coarse
kernel's launches and counters, the same maps as the coarse route forced
plain, and two calls in turn through one pair of graphs; the preview
render through the bilateral kernel and multi-scan registration on the
card against the CPU; the point-to-plane step's kernels against the plain
step at sweep16's shape (16 views at 1024x1280) and small ones, against
the float64 step from the cell's perturbed poses, a whole registration
at sweep16's settings against the plain route, repeatable bit for bit,
3 launches a step and no library kernel in a profile; K steps as one
CUDA graph against the steps one by one, bit for bit, directly and
through the runner's chunk path; the frame stager's host copies queued
on its stream, and timed under a profiler with no device record of the
program's spans; the lock window's median against numpy's, bit for bit,
at 1024x1280 and on small maps; and the streaming loop's overlap of
transfers with steps at 1216x1632, tests/test_streaming_tpu.py's bars).
Marked ``cuda``: each test skips where there is no card. On the card:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` because tests/conftest.py imports jax, which a machine
with the card need not have; chip_smoke.py runs the same comparisons at
the reference size.)"""

import dataclasses

import numpy as np
import pytest
import torch

from slc_tpu_torch import devtime, fusion, se3, synth
from slc_tpu_torch.calib import build_tables, synthetic_calibration
from slc_tpu_torch.config import (REFERENCE_CONFIG, HeterodyneConfig,
                                  SystemConfig)
from slc_tpu_torch.kernels import bilateral as kbil
from slc_tpu_torch.kernels import dynamic_step as kstep
from slc_tpu_torch.kernels import floors as kfl
from slc_tpu_torch.kernels import grayphase as kgray
from slc_tpu_torch.kernels import heterodyne as khet
from slc_tpu_torch.kernels import lock_window as klw
from slc_tpu_torch.kernels import mgsmooth as kmg
from slc_tpu_torch.kernels import p2l as kp2l
from slc_tpu_torch.kernels import phaselock as kpl
from slc_tpu_torch.kernels import stripe as kstripe
from slc_tpu_torch.ops import unwrap_spatial as U

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

SHAPES = [(96, 160), (90, 150)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _setup(h, w, dev):
    """The small test rig, or at a camera of 1000+ rows the reference's
    projector (800x1280, as chip_smoke.py runs it)."""
    if h >= 1000:
        cfg = dataclasses.replace(REFERENCE_CONFIG, cam_h=h, cam_w=w)
    else:
        cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640,
                           gray_bits=5)
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=cfg.pro_h,
                                  pro_w=cfg.pro_w)
    return cfg, calib, build_tables(calib, h, w, dev)


def _bits(t):
    """A float32 tensor's bits, for comparing maps that may hold NaN."""
    return t.contiguous().view(torch.int32)


def _close(got, want, atol):
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, atol=atol, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("min_mod", [None, 2.0])
def test_grayphase_kernel(dev, shape, min_mod):
    cfg, calib, tables = _setup(*shape, dev)
    scene = synth.render_static_scene(calib, cfg, synth.sphere_surface(),
                                      noise_sigma=1.0)
    g = torch.from_numpy(scene.gray_images).to(dev)
    p = torch.from_numpy(scene.phase_images).to(dev)
    got = kgray.grayphase_decode_cuda(g, p, tables, cfg, min_mod)
    want = kgray.grayphase_decode_ref(g, p, tables, cfg, min_mod)
    _close(got[:3], want[:3], 8e-3)
    _close(got[3:], want[3:], 2e-3)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("window", [5, 21, 63])
def test_stripe_kernel(dev, shape, subpixel, window):
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, shape, np.uint8)).to(dev)
    _close(kstripe.stripe_regression_cuda(frame, window, subpixel),
           kstripe.stripe_regression_ref(frame, window, subpixel), 1e-5)


def _step_args(shape, dev, window=None):
    """The step's inputs; the carried strips from the stripe regression
    of the previous frame at ``window`` (the config's by default). At
    1000+ rows the plane moves 0.3 per frame, as in chip_smoke.py."""
    cfg, calib, tables = _setup(*shape, dev)
    frames, _, pu_gt = synth.render_dynamic_sequence(
        calib, cfg, 2, dz_per_frame=0.3 if shape[0] >= 1000 else 0.08,
        stripe_period=12, noise_sigma=1.0)
    f0, f1 = (torch.from_numpy(f).to(dev) for f in frames)
    sw, sb = kstripe.stripe_regression_ref(f0, window or cfg.reco_window)
    pu = torch.from_numpy(pu_gt[0].astype(np.float32)).to(dev)
    return cfg, (f1, sw, sb, pu, tables)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reference_semantics", [False, True])
def test_step_kernels(dev, shape, reference_semantics):
    cfg, args = _step_args(shape, dev)
    on = not reference_semantics
    kw = dict(window=cfg.reco_window, subpixel=on, scale_gradient=on,
              robust=on, fov_min=cfg.fov_min, fov_max=cfg.fov_max)
    got = kstep.dynamic_step_open_cuda(*args, **kw)
    want = kstep.dynamic_step_open_ref(*args, **kw)
    for i, bar in enumerate((2e-4, 1e-5, 1e-5, 2e-3, 2e-4, 2e-4)):
        _close(got[i:i + 1], want[i:i + 1], bar)
    lk = dict(kw, period=12.0, win_u=21, win_v=9)
    got = kstep.dynamic_step_lock_cuda(*args, **lk)
    want = kstep.dynamic_step_lock_ref(*args, **lk)
    for i, bar in enumerate((2e-3, 1e-5, 1e-5, 4e-3, 4e-3, 4e-3)):
        _close(got[i:i + 1], want[i:i + 1], bar)


@pytest.mark.parametrize("shape", SHAPES + [(97, 157)])
@pytest.mark.parametrize("min_mod", [None, 2.0])
@pytest.mark.parametrize("steps", [4, 5])
def test_heterodyne_kernel(dev, shape, min_mod, steps):
    """Beat-order flips pinned as tests/conftest.py:40-61 pins them: at
    most 8, each exactly +-1 fine order, no 2x2 block; x, y, z 4e-3 off
    them, P 2e-3. 3 x 4 steps take the kernel's unrolled instance, 3 x 5
    its generic one; widths 150 and 157 its element-wise loads and
    stores."""
    cfg, calib, tables = _setup(*shape, dev)
    het = HeterodyneConfig(phase_steps=steps)
    imgs, _, _ = synth.render_fringe_stack(
        calib, cfg, synth.sphere_surface(), het.periods(cfg.pro_w),
        het.phase_steps, noise_sigma=1.0)
    f = torch.from_numpy(imgs).to(dev)
    got = khet.heterodyne_decode_cuda(f, tables, cfg, het, min_mod)
    want = khet.heterodyne_decode_ref(f, tables, cfg, het, min_mod)
    err = (got[3] - want[3]).cpu().numpy()
    div = np.abs(err) >= 1e-2
    assert div.sum() <= 8
    fine = het.periods(cfg.pro_w)[0]
    np.testing.assert_allclose(np.abs(err[div]) / fine, 1.0, atol=0.02)
    assert not (div[:-1, :-1] & div[1:, :-1] & div[:-1, 1:]
                & div[1:, 1:]).any()
    keep = torch.from_numpy(~div).to(dev)
    for g, e, bar in zip(got, want, (4e-3, 4e-3, 4e-3, 2e-3)):
        torch.testing.assert_close(g[keep], e[keep], atol=bar, rtol=0)


@pytest.mark.parametrize("shape", SHAPES + [(97, 157), (1, 1280), (1024, 1)])
@pytest.mark.parametrize("holes", [0.05, 0.5])
def test_bilateral_kernel(dev, shape, holes):
    """Widths 150, 157 and 1 take the kernel's element-wise loads and
    stores; one row and one column its image borders on every side."""
    rng = np.random.default_rng(0)
    z = 50.0 + rng.normal(0, 0.4, size=shape).astype(np.float32)
    z[rng.uniform(size=shape) < holes] = 0.0
    img = torch.from_numpy(z).to(dev)
    _close([kbil.bilateral_filter_cuda(img)], [kbil.bilateral_filter_ref(img)],
           1e-4)


@pytest.mark.parametrize("shape", SHAPES + [(97, 201), (1024, 1280),
                                   (512, 640), (256, 320), (1000, 1270),
                                   (500, 635), (250, 318)])
def test_mg_level_kernels(dev, shape):
    """The level kernels round every operation as the plain ops do: 2e-6
    on O(1) data (tests/test_pallas.py:404-437). 1024x1280 and 1000x1270
    take the 128x40 tiles, the other shapes the 128x8 ones; the widths
    not a multiple of 4, the element-wise loads and stores."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.uniform(0.1, 1.0, shape).astype(np.float32))
    wy, wx = U.edge_weights(q.to(dev))
    dinv = 1.0 / U._diag(wy, wx)
    r, e = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)
                             ).to(dev) for _ in range(2))
    _close(kmg.mg_down_cuda(r, wy, wx, dinv), kmg.mg_down_ref(r, wy, wx, dinv),
           2e-6)
    _close([kmg.mg_up_cuda(e, r, wy, wx, dinv)],
           [kmg.mg_up_ref(e, r, wy, wx, dinv)], 2e-6)


@pytest.mark.parametrize("shape,zero_row", [
    ((32, 40), None), ((24, 40), None), ((17, 29), None), ((1, 32), None),
    ((32, 1), None), ((64, 128), None), ((32, 40), 7)])
def test_mg_coarse_kernel(dev, shape, zero_row):
    """The coarsest level's kernel is the plain sweeps bit for bit: at
    the coarsest levels of 1024x1280 (32x40) and 96x160 (24x40), ragged,
    one row, one column, the largest level the routing admits (64x128,
    MG_COARSE_KERNEL_MAX px) and with a row of zero edge weights."""
    h, w = shape
    assert U.coarse_kernel_fits(h, w)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.uniform(0.1, 1.0, shape).astype(np.float32))
    wy, wx = U.edge_weights(q.to(dev))
    if zero_row is not None:
        wy[zero_row] = 0.0
        wx[zero_row] = 0.0
    dinv = 1.0 / U._diag(wy, wx)
    r = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)
    kmg.mg_coarse_cuda.launches = 0
    got = kmg.mg_coarse_cuda(r, wy, wx, dinv)
    assert kmg.mg_coarse_cuda.launches == 1
    assert torch.equal(_bits(got), _bits(kmg.mg_coarse_ref(r, wy, wx, dinv)))
    assert torch.equal(_bits(kmg.mg_coarse_cuda(r, wy, wx, dinv, 0.8, 5)),
                       _bits(kmg.mg_coarse_ref(r, wy, wx, dinv, 0.8, 5)))


def test_a_coarsest_level_above_the_rule_stays_plain(dev):
    """A 64x129 level, one column above MG_COARSE_KERNEL_MAX px: vcycle
    runs the plain sweeps on the card, no launch, and the kernel refuses
    it."""
    h, w = 64, 129
    assert not U.coarse_kernel_fits(h, w)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.uniform(0.1, 1.0, (h, w)).astype(np.float32))
    wy, wx = U.edge_weights(q.to(dev))
    dinv = 1.0 / U._diag(wy, wx)
    r = torch.from_numpy(rng.normal(0, 1, (h, w)).astype(np.float32)
                         ).to(dev)
    kmg.mg_coarse_cuda.launches = 0
    got = U.vcycle(r, [(wy, wx, dinv, (h, w))])
    assert kmg.mg_coarse_cuda.launches == 0
    assert torch.equal(_bits(got), _bits(kmg.mg_coarse_ref(r, wy, wx, dinv)))
    with pytest.raises(ValueError, match="does not fit"):
        kmg.mg_coarse_cuda(r, wy, wx, dinv)


def _box_scene(dev, h, w, seed):
    """tests/test_unwrap_spatial.py's box-step scene at (h, w), as
    chip_smoke.py's ``unwrap_scene``: a ramp 5 periods wide and 0.4 px a
    row, a box 3.7 periods high ringed by quality 0, noise 0.05, an
    anchor off by up to a third of a period. (t, psi, q, anchor) on the
    card."""
    rng = np.random.default_rng(seed)
    t = 32.0
    x = (np.linspace(0, 5 * t, w)[None, :]
         + 0.4 * np.arange(h)[:, None]).astype(np.float64)
    box = np.zeros((h, w), bool)
    box[h // 3: 2 * h // 3, w // 3: 2 * w // 3] = True
    x = x + 3.7 * t * box
    psi = np.mod(x + rng.normal(0, 0.05, (h, w)), t).astype(np.float32)
    ring = np.zeros_like(box)
    ring[h // 3 - 2: 2 * h // 3 + 2, w // 3 - 2: 2 * w // 3 + 2] = True
    ring[h // 3 + 2: 2 * h // 3 - 2, w // 3 + 2: 2 * w // 3 - 2] = False
    q = np.where(ring, 0.0, 1.0).astype(np.float32)
    anchor = (x + rng.uniform(-t / 3, t / 3, x.shape)).astype(np.float32)
    return (t,) + tuple(torch.from_numpy(a).to(dev)
                        for a in (psi, q, anchor))


class _EagerCG:
    """A stand-in for ``_cg_graphs``' graphs that runs the CG loop
    launch by launch: ``unwrap_spatial`` on the card through the eager
    loop."""

    def __init__(self, dev, h, w, period, tol, mg):
        self.args = (period, tol, mg)

    def run(self, psi, quality, anc, max_iters):
        return U._cg_eager(psi, quality, anc, *self.args, max_iters)


def _unwrap_counted(monkeypatch, eager, *args, **kw):
    """unwrap_spatial(*args, return_info=True, **kw) through the graphs
    or (``eager``) the eager loop, with the launch counts of mg_down,
    mg_up and mg_coarse from 0, under a profiler: (P, info, launches,
    counters)."""
    from slc_tpu_torch import metrics
    kmg.mg_down_cuda.launches = kmg.mg_up_cuda.launches = 0
    kmg.mg_coarse_cuda.launches = 0
    metrics.reset()
    with monkeypatch.context() as m:
        if eager:
            m.setattr(U, "_cg_graphs", _EagerCG)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            p, info = U.unwrap_spatial(*args, return_info=True, **kw)
    torch.cuda.synchronize()
    launches = (kmg.mg_down_cuda.launches, kmg.mg_up_cuda.launches,
                kmg.mg_coarse_cuda.launches)
    counters = metrics.counters()
    metrics.reset()
    return p, info, launches, counters


def _same_unwrap(got, want):
    """P, the iteration count and the relative residual, bit for bit."""
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert got[1]["cg_iters"] == want[1]["cg_iters"] >= 1
    assert torch.equal(_bits(got[1]["rel_residual"]),
                       _bits(want[1]["rel_residual"]))


@pytest.mark.parametrize("mg", [True, False], ids=["mg", "jacobi"])
@pytest.mark.parametrize("anchored", [False, True],
                         ids=["unanchored", "anchored"])
@pytest.mark.parametrize("shape", [(1024, 1280), (1000, 1270), (96, 160)])
def test_cg_graphs_equal_the_eager_loop(dev, monkeypatch, shape, anchored,
                                        mg):
    """The unwrap's CG through its two CUDA graphs gives the eager loop's
    P, iterations and residual bit for bit (the same kernels in the same
    order); the multigrid kernels' launch counts move as the eager
    loop's (the capture adds none), the coarse kernel's once a coarsest
    visit (4 a preconditioner call at 1024x1280 and 1000x1270, 2 at
    96x160; 1 + cg_iters calls), which both count as
    ``unwrap.coarse_kernel`` = ``unwrap.coarse_visits``; and every start
    and iteration is a replay, ``unwrap.graph_replays`` =
    ``unwrap.calls`` + ``unwrap.cg_iters``."""
    t, psi, q, anchor = _box_scene(dev, *shape, seed=1)
    args = (psi, t)
    kw = dict(quality=q, anchor=anchor if anchored else None, mg=mg)
    got = _unwrap_counted(monkeypatch, False, *args, **kw)
    want = _unwrap_counted(monkeypatch, True, *args, **kw)
    _same_unwrap(got, want)
    assert got[2] == want[2]
    assert (got[2][0] > 0) == (mg and min(shape) >= U.MG_KERNEL_MIN)
    visits = COARSE_VISITS[shape] * (1 + got[1]["cg_iters"]) if mg else 0
    assert got[2][2] == visits
    for run in (got, want):
        assert run[3]["unwrap.coarse_kernel"] \
            == run[3]["unwrap.coarse_visits"] == visits
    c = got[3]
    assert c["unwrap.calls"] == 1
    assert c["unwrap.graph_replays"] == 1 + c["unwrap.cg_iters"] \
        == 1 + got[1]["cg_iters"]
    assert "unwrap.graph_replays" not in want[3]


#: The K-cycle's coarsest visits a preconditioner call: 4 where the
#: hierarchy reaches four levels below the top, 2 at 96x160 (96x160,
#: 48x80, 24x40).
COARSE_VISITS = {(1024, 1280): 4, (1000, 1270): 4, (96, 160): 2}


@pytest.mark.parametrize("anchored", [False, True],
                         ids=["unanchored", "anchored"])
@pytest.mark.parametrize("shape", [(1024, 1280), (1000, 1270), (96, 160)])
def test_coarse_kernel_keeps_the_plain_routes_map(dev, monkeypatch, shape,
                                                  anchored):
    """unwrap_spatial through the graphs with the coarse kernel gives P,
    cg_iters and rel_residual bit for bit as with the coarse route forced
    plain (graphs captured anew, with no coarse launch): the map the
    plain coarse level gave before the kernel."""
    t, psi, q, anchor = _box_scene(dev, *shape, seed=4)
    kw = dict(quality=q, anchor=anchor if anchored else None)
    got = _unwrap_counted(monkeypatch, False, psi, t, **kw)
    with monkeypatch.context() as m:
        m.setattr(U, "coarse_kernel_fits", lambda h, w: False)
        m.setattr(U, "_cg_graphs", lambda *a: U._CGGraphs(*a))
        plain = _unwrap_counted(monkeypatch, False, psi, t, **kw)
    _same_unwrap(got, plain)
    assert got[2][2] == COARSE_VISITS[shape] * (1 + got[1]["cg_iters"])
    assert plain[2][2] == 0 and plain[3]["unwrap.coarse_kernel"] == 0
    assert plain[3]["unwrap.coarse_visits"] == got[2][2]


@pytest.mark.parametrize("shape", [(1024, 1280), (96, 160)])
def test_cg_graphs_serve_calls_in_turn(dev, monkeypatch, shape):
    """Two calls through one cached pair of graphs, the second anchored
    on the first's map, as a re-scan chains them: each equals the eager
    loop's, the second is no capture, and the first's map, the second's
    anchor, is left as it was."""
    t, psi, q, anchor = _box_scene(dev, *shape, seed=2)
    _, psi2, q2, _ = _box_scene(dev, *shape, seed=3)
    first = _unwrap_counted(monkeypatch, False, psi, t, quality=q,
                            anchor=anchor)
    kept = first[0].clone()
    second = _unwrap_counted(monkeypatch, False, psi2, t, quality=q2,
                             anchor=first[0])
    assert "unwrap.graph_captures" not in second[3]
    assert torch.equal(_bits(first[0]), _bits(kept))
    _same_unwrap(first, _unwrap_counted(monkeypatch, True, psi, t,
                                        quality=q, anchor=anchor))
    _same_unwrap(second, _unwrap_counted(monkeypatch, True, psi2, t,
                                         quality=q2, anchor=kept))
    assert not torch.equal(first[0], second[0])


@pytest.mark.parametrize("shape", SHAPES)
def test_phase_lock_kernel(dev, shape):
    """At the locked step's bars; the prediction is only read."""
    cfg, calib, tables = _setup(*shape, dev)
    frames, _, pu_gt = synth.render_dynamic_sequence(
        calib, cfg, 2, stripe_period=12, noise_sigma=1.0)
    pred = torch.from_numpy(pu_gt[1].astype(np.float32) + 1.3).to(dev)
    pred[:, 40:48] = 0.0
    keep = pred.clone()
    f = torch.from_numpy(frames[1]).to(dev)
    kw = dict(period=12.0, win_u=21, win_v=9, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max)
    got = kpl.phase_lock_cuda(f, pred, tables, **kw)
    assert torch.equal(pred, keep)
    want = kpl.phase_lock_ref(f, pred, tables, **kw)
    for i, bar in enumerate((2e-3, 4e-3, 4e-3, 4e-3)):
        _close(got[i:i + 1], want[i:i + 1], bar)


#: The lock's windows: the smallest the wrappers take, the reference's
#: and the largest, whose shared-memory plan needs more than 48 KB.
LOCK_WINDOWS = [(3, 3), (21, 9), (63, 63)]
#: The carrier gate: off (threshold 0), on, and on with the first band's
#: prediction stretched by 10% so that its gradient exceeds the threshold.
GATES = ["off", "on", "over"]
LOCK_BARS = (2e-3, 4e-3, 4e-3, 4e-3)


def _lock_close(got, want, flips=2):
    """P within 2e-3 off at most ``flips`` isolated arccos tie pixels, each
    moved by at most T/2 (chip_smoke.py pins up to 32 at 1.3 MP); z, x, y
    within 4e-3 off those pixels."""
    d = (got[0] - want[0]).abs()
    flip = d > LOCK_BARS[0]
    assert int(flip.sum()) <= flips and float(d.max()) <= 6.0 + LOCK_BARS[0]
    assert not bool((flip[:-1, :-1] & flip[1:, :-1] & flip[:-1, 1:]
                     & flip[1:, 1:]).any())
    keep = ~flip
    for g, e, bar in zip(got, want, LOCK_BARS):
        torch.testing.assert_close(g[keep], e[keep], atol=bar, rtol=0)


def _gated(p, gate):
    """``p`` with the first gate band stretched for ``gate`` "over", and
    the gate's threshold."""
    if gate == "over":
        p = p.clone()
        p[:64] *= 1.1
    return p, 0.0 if gate == "off" else 2e-3


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("win_u,win_v", LOCK_WINDOWS)
@pytest.mark.parametrize("gate", GATES)
def test_lock_windows_and_gate(dev, shape, win_u, win_v, gate):
    """The standalone lock against its plain version, with a hole band
    (P = 0, never corrected); a band over the gate's threshold is left
    as predicted by both."""
    cfg, calib, tables = _setup(*shape, dev)
    frames, _, pu_gt = synth.render_dynamic_sequence(
        calib, cfg, 2, stripe_period=12, noise_sigma=1.0)
    pred, thresh = _gated(
        torch.from_numpy(pu_gt[1].astype(np.float32) + 1.3).to(dev), gate)
    pred[:, 40:48] = 0.0
    f = torch.from_numpy(frames[1]).to(dev)
    kw = dict(period=12.0, win_u=win_u, win_v=win_v,
              max_carrier_gradient=thresh, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max)
    got = kpl.phase_lock_cuda(f, pred, tables, **kw)
    want = kpl.phase_lock_ref(f, pred, tables, **kw)
    _lock_close(got, want)
    assert bool((got[0][:, 40:48] == 0).all())
    if gate == "over":
        assert torch.equal(got[0][:64], pred[:64])
        assert torch.equal(want[0][:64], pred[:64])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("win_u,win_v", LOCK_WINDOWS)
@pytest.mark.parametrize("gate", GATES)
def test_locked_step_windows_and_gate(dev, shape, win_u, win_v, gate):
    """The locked step against its plain version, with a hole band in the
    carried P."""
    cfg, (f1, sw, sb, pu, tables) = _step_args(shape, dev)
    pu, thresh = _gated(pu, gate)
    pu[:, 40:48] = 0.0
    kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max, period=12.0, win_u=win_u, win_v=win_v,
              max_carrier_gradient=thresh)
    args = (f1, sw, sb, pu, tables)
    got = kstep.dynamic_step_lock_cuda(*args, **kw)
    want = kstep.dynamic_step_lock_ref(*args, **kw)
    _close(got[1:3], want[1:3], 1e-5)
    _lock_close(got[:1] + got[3:], want[:1] + want[3:])


@pytest.mark.parametrize("shape", [(192, 160), (150, 150)])
@pytest.mark.parametrize("period", [12.0, 12.6, 11.4])
def test_locked_step_gates_match_plain(dev, shape, period):
    """The snap launch's per-band gate decisions equal the plain step's:
    none gated at the true period, every band at a 5% wrong one."""
    from slc_tpu_torch.ops.demod import GATE_BAND
    cfg, args = _step_args(shape, dev)
    n = -(-shape[0] // GATE_BAND)
    kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max, period=period, win_u=21, win_v=9)
    got, want = (torch.full((n,), -1.0, device=dev) for _ in range(2))
    out = kstep.dynamic_step_lock_cuda(*args, gates=got, **kw)
    ref = kstep.dynamic_step_lock_ref(*args, gates=want, **kw)
    assert got.tolist() == want.tolist()
    assert got.tolist() == [0.0 if period != 12.0 else 1.0] * n
    _lock_close(out[:1] + out[3:], ref[:1] + ref[3:])


@pytest.mark.parametrize("shape", SHAPES + [(1000, 1270)])
@pytest.mark.parametrize("window", [5, 21, 63])
@pytest.mark.parametrize("subpixel,frac_bits", [(True, 0), (False, 0),
                                                (True, 7)])
def test_track_windows(dev, shape, window, subpixel, frac_bits):
    """The track launch at every extrema width it takes (four pixels a
    thread at window 5, eight above), ragged and at 1000x1270: the
    open-loop step and the locked step against their plain versions,
    the carried strips from the stripe regression at the same window."""
    cfg, args = _step_args(shape, dev, window)
    kw = dict(window=window, subpixel=subpixel, frac_bits=frac_bits,
              fov_min=cfg.fov_min, fov_max=cfg.fov_max)
    got = kstep.dynamic_step_open_cuda(*args, **kw)
    want = kstep.dynamic_step_open_ref(*args, **kw)
    for i, bar in enumerate((2e-4, 1e-5, 1e-5, 2e-3, 2e-4, 2e-4)):
        _close(got[i:i + 1], want[i:i + 1], bar)
    lk = dict(kw, period=12.0, win_u=21, win_v=9)
    got = kstep.dynamic_step_lock_cuda(*args, **lk)
    want = kstep.dynamic_step_lock_ref(*args, **lk)
    _close(got[1:3], want[1:3], 1e-5)
    _lock_close(got[:1] + got[3:], want[:1] + want[3:],
                flips=32 if shape[0] > 100 else 2)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("frac_bits", [0, 7])
def test_two_kernel_locked_step_equals_fused(dev, shape, frac_bits):
    """Open-loop step, then the standalone lock on its P: the same device
    code as the fused locked step, so bit-identical."""
    cfg, args = _step_args(shape, dev)
    kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max, frac_bits=frac_bits)
    lk = dict(period=12.0, win_u=21, win_v=9)
    pu1, sw, sb = kstep.dynamic_step_open_cuda(*args, **kw)[:3]
    pu, z, x, y = kpl.phase_lock_cuda(args[0], pu1, args[-1], **lk,
                                      fov_min=cfg.fov_min,
                                      fov_max=cfg.fov_max)
    fused = kstep.dynamic_step_lock_cuda(*args, **kw, **lk)
    for a, b in zip((pu, sw, sb, z, x, y), fused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,halo", [(torch.uint8, 10),
                                        (torch.float32, 1)])
@pytest.mark.parametrize("n_out", [1, 2])
def test_floor_kernel(dev, shape, dtype, halo, n_out):
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, shape).astype(
        np.uint8 if dtype == torch.uint8 else np.float32)).to(dev)
    got = kfl.halo_block_floor_cuda(img, halo, n_out)
    for g, e in zip(got, kfl.halo_block_floor_ref(img, halo, n_out)):
        assert torch.equal(g, e)


@pytest.mark.parametrize("width", [1270, 1276, 1279, 1280])
@pytest.mark.parametrize("halo", [0, 1, 10, 31])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_floor_kernel_alignment_paths(dev, width, halo, dtype):
    """Every path of the floors' staging and stores, exact for n_out 1
    and 2: 16-byte rows and float4 stores (1280), float4 stores with u8
    rows staged byte by byte (1276), element by element (1270, 1279)."""
    rng = np.random.default_rng(halo)
    img = torch.from_numpy(rng.integers(0, 256, (40, width)).astype(
        np.uint8 if dtype == torch.uint8 else np.float32)).to(dev)
    for n_out in (1, 2):
        got = kfl.halo_block_floor_cuda(img, halo, n_out)
        for g, e in zip(got, kfl.halo_block_floor_ref(img, halo, n_out)):
            assert torch.equal(g, e)


@pytest.mark.parametrize("shape", SHAPES)
def test_fast_subpixel_kernels(dev, shape):
    """frac_bits=7: the same quantization as the plain versions."""
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, shape, np.uint8)).to(dev)
    _close(kstripe.stripe_regression_cuda(frame, 21, True, 7),
           kstripe.stripe_regression_ref(frame, 21, True, 7), 1e-5)
    cfg, args = _step_args(shape, dev)
    kw = dict(window=cfg.reco_window, fov_min=cfg.fov_min,
              fov_max=cfg.fov_max, frac_bits=7)
    got = kstep.dynamic_step_open_cuda(*args, **kw)
    want = kstep.dynamic_step_open_ref(*args, **kw)
    for i, bar in enumerate((2e-4, 1e-5, 1e-5, 2e-3, 2e-4, 2e-4)):
        _close(got[i:i + 1], want[i:i + 1], bar)
    lk = dict(kw, period=12.0, win_u=21, win_v=9)
    got = kstep.dynamic_step_lock_cuda(*args, **lk)
    want = kstep.dynamic_step_lock_ref(*args, **lk)
    for i, bar in enumerate((2e-3, 1e-5, 1e-5, 4e-3, 4e-3, 4e-3)):
        _close(got[i:i + 1], want[i:i + 1], bar)


def test_ablate_and_device_time(dev):
    """Each ablated locked step runs; where the profiler records CUDA
    kernels it sees the step's kernels by name, and their time alone is
    below the call's, which also counts the wrapper's host time between
    the launches."""
    cfg, args = _step_args(SHAPES[0], dev)
    kw = dict(window=cfg.reco_window, period=12.0, win_u=21, win_v=9)
    for ab in ("track", "dc", "corr"):
        kstep.dynamic_step_lock_cuda(*args, **kw, ablate=ab)
    torch.cuda.synchronize()

    def step():
        return kstep.dynamic_step_lock_cuda(*args, **kw)
    call = devtime.device_time_s(step, n=3)
    if not devtime.profiler_sees_cuda():
        return                      # CUPTI denied: the call time only
    alone = devtime.device_time_s(step, n=3, match="")
    assert 0 < alone < call
    for name in ("track_kernel", "lock_dc_kernel", "lock_corr_kernel",
                 "snap_kernel"):
        assert 0 < devtime.device_time_s(step, n=3, match=name) < alone


def test_graph_time(dev):
    """The locked step's launches replayed as a CUDA graph: the warm-ups
    and the captured calls each launch once, the device time is below the
    call's, and the replays leave the caller's tensors as they were."""
    cfg, args = _step_args(SHAPES[0], dev)
    kw = dict(window=cfg.reco_window, period=12.0, win_u=21, win_v=9)
    keep = [a.clone() for a in args[:4]]

    def step():
        return kstep.dynamic_step_lock_cuda(*args, **kw)
    call = devtime.device_time_s(step, n=3)
    kstep.dynamic_step_lock_cuda.launches = 0
    alone = devtime.graph_time_s(step, n=3, warmup=2)
    assert kstep.dynamic_step_lock_cuda.launches == 5
    assert 0 < alone < call
    for a, b in zip(args[:4], keep):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES + [(1024, 1280)])
def test_preview_render_through_the_kernel(dev, shape):
    """cloud.render_depth_map on the card launches the bilateral kernel
    once, and its u8 is within 1 of the plain chain's on at most 0.1% of
    the pixels."""
    from slc_tpu_torch import cloud
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    z = (40.0 + 0.05 * xx - 0.03 * yy + rng.normal(0, 0.01, shape))
    z[rng.uniform(size=shape) < 0.05] = 0.0
    z = torch.from_numpy(z.astype(np.float32)).to(dev)
    k = (200.0, 190.0, shape[1] / 2, shape[0] / 2)
    kbil.bilateral_filter_cuda.launches = 0
    got = cloud.render_depth_map(z, *k)
    assert kbil.bilateral_filter_cuda.launches == 1
    f = kbil.bilateral_filter_ref(z)
    n, ok = cloud.cloud_normals(cloud.depth_to_cloud(f, *k), f > 0)
    want = cloud.luminance_map(cloud.depth_to_cloud(z, *k), n, ok)
    d = (got.int() - want.int()).abs()
    assert got.dtype == torch.uint8 and got.device == z.device
    assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * z.numel()


def test_register_scans_on_the_card(dev):
    """Registration on the card: within 2e-3 of the same call on the CPU,
    and bit-identical whatever float32 matmul precision the caller set."""
    from slc_tpu_torch import se3
    from slc_tpu_torch.fusion_frontend import register_scans
    h, w, s = 120, 160, 4
    calib = synthetic_calibration(cam_h=h, cam_w=w, cam_f=130.0)
    rot, trans = [], []
    for i in range(s):
        rot.append(se3.exp_so3(torch.tensor([0.0, 0.06 * i, 0.0])).numpy())
        trans.append(np.array([2.0 * i, 0.1 * i, -0.5 * i], np.float32))
    depths = np.stack([synth.render_depth_from_pose(calib, h, w, r, t)
                       for r, t in zip(rot, trans)]).astype(np.float32)
    rot0 = np.stack(rot)
    trans0 = np.stack(trans) + np.float32(0.1)
    trans0[0] = trans[0]
    args = (depths, calib.cam_k.numpy(), rot0, trans0)
    kw = dict(rounds=4, gn_iters=5, grid_step=6, max_depth_err=2.0)
    got = register_scans(*args, device=dev, **kw)
    want = register_scans(*args, device="cpu", **kw)
    for g, e in zip(got, want):
        torch.testing.assert_close(g.cpu(), e, atol=2e-3, rtol=0)
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        again = register_scans(*args, device=dev, **kw)
    finally:
        torch.set_float32_matmul_precision(prec)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.fixture(scope="module")
def sweep_views():
    """sweep16's views as numpy: 16 depth maps at 1024x1280 ray-cast on the
    host from an orbit about (0, 0, 62) (0.006 / 0.025 rad a step,
    chip_smoke.py's fusion scene) through the rig's 600-px camera, the
    true poses, and initial poses perturbed as the cell's are (0.01 rad,
    0.15 a component; seed 7). Returns (depths, cam_k, rot_gt, trans_gt,
    rot0, trans0)."""
    h, w, s = 1024, 1280, 16
    calib = synthetic_calibration(cam_h=h, cam_w=w, cam_f=600.0)
    center = np.array([0.0, 0.0, 62.0])

    def rot_of(v):
        return se3.exp_so3(torch.tensor(v, dtype=torch.float32)).numpy() \
            .astype(np.float64)
    rot_gt = np.stack([rot_of([0.006 * (i - 8), 0.025 * (i - 8), 0.0])
                       for i in range(s)])
    trans_gt = np.stack([(np.eye(3) - r) @ center for r in rot_gt])
    depths = np.stack([synth.render_depth_from_pose(calib, h, w, rot_gt[i],
                                                    trans_gt[i])
                       for i in range(s)]).astype(np.float32)
    rng = np.random.default_rng(7)
    rot0, trans0 = rot_gt.copy(), trans_gt.copy()
    for i in range(1, s):
        rot0[i] = rot_of(rng.normal(0, 0.01, 3)) @ rot0[i]
        trans0[i] = trans0[i] + rng.normal(0, 0.15, 3)
    f32 = (lambda a: np.asarray(a, np.float32))
    return (depths, calib.cam_k.numpy(), f32(rot_gt), f32(trans_gt),
            f32(rot0), f32(trans0))


#: sweep16's registration settings.
SWEEP = dict(rounds=8, gn_iters=5, grid_step=16, max_depth_err=2.0,
             normal_radius=7)


def _sweep_step_inputs(dev, views, perturbed):
    """One step's inputs at sweep16's shape on the card: the views
    associated (grid step 16, normal radius 7: S = 16, L = 81,920) at the
    true or the perturbed poses. Returns (rot, trans, landmarks, normals,
    obs, mask)."""
    from slc_tpu_torch.fusion_frontend import associate_projective
    depths, cam_k, rot_gt, trans_gt, rot0, trans0 = (
        torch.from_numpy(a).to(dev) for a in views)
    rot, trans = (rot0, trans0) if perturbed else (rot_gt, trans_gt)
    obs, mask, lm, nrm = associate_projective(
        depths, cam_k, rot, trans, SWEEP["grid_step"], SWEEP["max_depth_err"],
        SWEEP["normal_radius"])
    assert tuple(obs.shape) == (16, 81920, 3)
    return rot, trans, lm, nrm, obs, mask


def _small_step_inputs(dev, s, l):
    """A seeded ``synthetic_problem`` of S views and L landmarks with
    noisy observations, random unit normals and perturbed poses."""
    rng = np.random.default_rng(s * 1000 + l)
    obs, mask, rot_gt, trans_gt = fusion.synthetic_problem(
        rng, s=s, l=l, noise=0.01, device="cpu")
    n = rng.normal(size=(l, 3)).astype(np.float32)
    nrm = torch.from_numpy(n / np.linalg.norm(n, axis=1, keepdims=True))
    lm = torch.einsum("ij,lj->li", rot_gt[0], obs[0]) + trans_gt[0]
    turn = torch.stack([se3.exp_so3(torch.from_numpy(
        rng.normal(0, 0.01, 3).astype(np.float32))) for _ in range(s)])
    trans = trans_gt + torch.from_numpy(
        rng.normal(0, 0.1, (s, 3)).astype(np.float32))
    return tuple(a.to(dev) for a in (turn @ rot_gt, trans, lm, nrm, obs,
                                     mask))


def _plain_step(*args, dtype=torch.float32):
    """The plain step on the card (an identity ``reduce_fn`` keeps it off
    the kernels), its inputs in ``dtype``."""
    with fusion.full_f32():
        return fusion._gn_step_p2l(*(a.to(dtype) for a in args), 1e-3,
                                   reduce_fn=lambda x: x)


@pytest.mark.parametrize("case", ["sweep16", (4, 64), (4, 4096),
                                  (3, 1001)], ids=str)
def test_p2l_kernel_step_matches_the_plain_step(dev, request, case):
    """One kernel step against the plain step on the same inputs, rotation
    entries and translation components within 1e-5: at sweep16's shape
    (S = 16, L = 81,920, the views associated at their true poses) and at
    small shapes (one block a view, 16, and a ragged 4). The two sum in
    other orders; the translations (|t| up to ~12) are updated as
    exp(w) (t - c) + c + dt with |c| ~ 62, whose float32 rounding is 3.8e-6
    at 62, so two orders part by a few of those (1.9e-6 on the H100 at
    sweep16's shape). From the cell's
    perturbed poses the float32 step itself is not good to 1e-5: there
    the next test holds the kernels' step to the float64 one."""
    args = (_sweep_step_inputs(dev, request.getfixturevalue("sweep_views"),
                               False) if case == "sweep16"
            else _small_step_inputs(dev, *case))
    kp2l.gn_step_p2l_cuda.launches = 0
    got = fusion._gn_step_p2l(*args, 1e-3)
    assert kp2l.gn_step_p2l_cuda.launches == 3
    want = _plain_step(*args)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    assert int(got[3]) == 0 and int(want[3]) == 0
    assert got[2] is args[2]


def test_p2l_kernel_step_near_the_float64_step(dev, sweep_views):
    """From the cell's perturbed poses (a step of ~0.02 rad and ~0.3) the
    6x6 systems are ill-conditioned enough that float32 sums move the step
    visibly: the plain step, whose products cuBLAS sums along L in one
    sequence, reads ~2e-4 on rotation entries and ~2e-3 on translation
    components from its float64 evaluation on the H100, and 3.5e-6 and
    4.2e-5 on the host. The kernels sum in trees; their step stays within
    1e-5 on rotation entries and 1e-4 on translation components of the
    plain step evaluated in float64 on the same inputs."""
    args = _sweep_step_inputs(dev, sweep_views, True)
    got = fusion._gn_step_p2l(*args, 1e-3)
    exact = _plain_step(*args, dtype=torch.float64)
    plain = _plain_step(*args)
    gaps = {}
    for what, out in (("kernel", got), ("plain", plain)):
        gaps[what] = [float((a.double() - b).abs().max())
                      for a, b in zip(out[:2], exact[:2])]
    print(f"gaps to the float64 step (rotation, translation): {gaps}")
    assert gaps["kernel"][0] <= 1e-5 and gaps["kernel"][1] <= 1e-4, gaps


def test_p2l_kernel_takes_float32_alone(dev):
    """A CUDA tensor never falls back to the plain step: float64 on the
    card raises."""
    args = _small_step_inputs(dev, 4, 64)
    with pytest.raises(TypeError, match="float32"):
        fusion._gn_step_p2l(*(a.double() for a in args), 1e-3)


def test_register_scans_through_the_p2l_kernel(dev, monkeypatch,
                                               sweep_views):
    """A whole registration at sweep16's settings (8 rounds of 5 steps, grid
    step 16, normal radius 7, anchor gauge) through the kernels: within
    1e-4 of the plain route on the same card (the cell's fuse_pose_gap
    limit), bit-identical across two runs, 3 launches a step, 40 steps."""
    from slc_tpu_torch.fusion_frontend import register_scans
    depths, cam_k, _, _, rot0, trans0 = sweep_views
    args = (depths, cam_k, rot0, trans0)
    kp2l.gn_step_p2l_cuda.launches = 0
    got = register_scans(*args, device=dev, **SWEEP)
    steps = SWEEP["rounds"] * SWEEP["gn_iters"]
    assert kp2l.gn_step_p2l_cuda.launches == 3 * steps
    again = register_scans(*args, device=dev, **SWEEP)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    monkeypatch.setattr(fusion, "_p2l_kernel_route",
                        lambda obs, reduce_fn=None: False)
    kp2l.gn_step_p2l_cuda.launches = 0
    want = register_scans(*args, device=dev, **SWEEP)
    assert kp2l.gn_step_p2l_cuda.launches == 0
    gap = max(float((g - w).abs().max()) for g, w in zip(got, want))
    print(f"register_scans, kernels against plain: {gap:.3e}")
    assert gap <= 1e-4


_PROFILE_P2L = r"""
import json
import numpy as np
import torch
from slc_tpu_torch import devtime, fusion
rng = np.random.default_rng(0)
obs, mask, rot, trans = fusion.synthetic_problem(rng, s=16, l=81920,
                                                 noise=0.01, device="cuda")
n = rng.normal(size=(81920, 3)).astype(np.float32)
nrm = torch.from_numpy(n / np.linalg.norm(n, axis=1, keepdims=True)).cuda()
lm = torch.einsum("ij,lj->li", rot[0], obs[0]) + trans[0]
names = None
if devtime.profiler_sees_cuda():
    fusion._fuse_scans_p2l(obs, mask, nrm, rot, trans, lm, 5, 1e-3)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fusion._fuse_scans_p2l(obs, mask, nrm, rot, trans, lm, 5, 1e-3)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
print(json.dumps(names))
"""


def test_p2l_fuse_runs_no_library_kernel(dev):
    """A profiled ``_fuse_scans_p2l`` call of 5 steps at sweep16's S = 16
    and L = 81,920 records the three p2l kernels once a step each, and no
    cuBLAS or cuSOLVER kernel (no GEMM, no LU). It profiles in a process
    of its own: after other profiled tests a process's profiler may
    record no CUDA kernel."""
    import json
    import os
    import re
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _PROFILE_P2L], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    if names is None:
        pytest.skip("torch.profiler records no CUDA kernel in a new process")
    library = [n for n in names if re.search(
        r"gemm|cublas|cusolver|getr[fs]|trsm|xmma|magma|potr", n, re.I)]
    assert not library, library
    for k in ("p2l_stats_kernel", "p2l_normal_kernel", "p2l_solve_kernel"):
        assert sum(k in n for n in names) == 5, (k, names)


def _moving_plane(dev, h, w, n, dz=0.05, cfg=None):
    """n rendered frames of a moving plane and the tracker state at frame
    0 on the card."""
    from slc_tpu_torch.dynamic import init_tracker
    if cfg is None:
        cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=h, pro_w=w)
    calib = synthetic_calibration(cam_h=h, cam_w=w, pro_h=cfg.pro_h,
                                  pro_w=cfg.pro_w)
    tables = build_tables(calib, h, w, dev)
    frames, zs, pus = synth.render_dynamic_sequence(
        calib, cfg, n, z0=50.0, dz_per_frame=dz, stripe_period=12,
        noise_sigma=1.0)
    state = init_tracker(torch.from_numpy(frames[0]).to(dev),
                         torch.from_numpy(pus[0].astype(np.float32)).to(dev),
                         torch.from_numpy(zs[0].astype(np.float32)).to(dev),
                         cfg)
    return cfg, tables, frames, state


def test_streaming_hides_transfers(dev):
    """The port of tests/test_streaming_tpu.py: at 1216x1632 the
    pipelined loop beats the strict sequential one and hides at least
    half of the cheaper leg under the other (best of 3)."""
    from slc_tpu_torch.streaming import measure_overlap
    cfg, tables, frames, state = _moving_plane(dev, 1216, 1632, 9)
    best = None
    for _ in range(3):
        ov = measure_overlap(state, frames[1:], tables, cfg)
        if best is None or ov["overlap_efficiency"] > \
                best["overlap_efficiency"]:
            best = ov
    print("overlap:", best)
    assert best["speedup_vs_sequential"] > 1.1, best
    assert best["overlap_efficiency"] >= 0.5, best


def test_stager_keeps_the_frame_until_its_copy(dev):
    """``put`` returns before the copy runs (here it waits behind ~20 ms
    of a spinning kernel), so the stager must hold the numpy frame: the
    frame freed right after ``put`` and its memory written over, the
    device tensor still holds the frame's values."""
    import gc
    from slc_tpu_torch.kernels import staging
    from slc_tpu_torch.streaming import HostStager
    rng = np.random.default_rng(5)
    want = rng.integers(0, 256, (1024, 1280), dtype=np.uint8)
    stager = HostStager(dev)
    staging.stage_h2d.launches = 0
    torch.cuda._sleep(40_000_000)
    stager._stream.wait_stream(torch.cuda.current_stream(dev))
    frame = want.copy()
    staged = stager.put(frame)
    del frame
    gc.collect()
    junk = [np.full((1024, 1280), 255, np.uint8) for _ in range(8)]
    got = staged.wait().cpu().numpy()
    assert staging.stage_h2d.launches == 1
    np.testing.assert_array_equal(got, want)
    del junk


def test_stacked_and_slot_puts_match_per_frame_puts(dev):
    """A stack staged by one ``put`` of a list, and frames staged one by
    one into the slots of a device stack (``out``, behind queued work on
    the current stream), equal the frames staged one at a time, bit for
    bit, with more puts in flight than the ring has buffers."""
    from slc_tpu_torch.streaming import HostStager
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (96, 160), dtype=np.uint8)
              for _ in range(7)]
    stager = HostStager(dev, slots=2)
    one = [stager.put(f) for f in frames]
    stack = stager.put(frames).wait()
    torch.cuda._sleep(10_000_000)
    # Queued behind the spin: a put that did not wait for it would be
    # written over.
    slots = torch.full((7, 96, 160), 3, dtype=torch.uint8, device=dev)
    for f, slot in zip(frames, slots):
        stager.put(f, out=slot)
    want = torch.from_numpy(np.stack(frames)).to(dev)
    assert torch.equal(torch.stack([s.wait() for s in one]), want)
    assert torch.equal(stack, want)
    assert torch.equal(slots, want)


def test_spans_time_the_stager_with_no_device_mirror(dev):
    """Under a profiler of the CPU and the card, a put's staging host
    function is timed (a job a put, its memcpy above 0), the program's
    spans are CPU records only (none named ``slc.*`` on the device), and
    the staged frames are right; without a profiler a put times
    nothing."""
    from slc_tpu_torch import metrics
    from slc_tpu_torch.streaming import HostStager
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (1024, 1280), dtype=np.uint8)
              for _ in range(5)]
    stager = HostStager(dev)
    stager.put(frames[0]).wait()                # builds the library
    torch.cuda.synchronize(dev)
    metrics.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = [stager.put(f).wait() for f in frames]
        torch.cuda.synchronize(dev)
    c = metrics.counters()
    assert c["stage.jobs"] == 5 and c["stage.copy_ns"] > 0
    assert 0 <= c["stage.fn_delay_max_ns"] <= c["stage.fn_delay_ns"]
    assert metrics.span_totals()["stream.put"]["calls"] == 5
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("slc.")]
    assert ours and all(e.device_type() == torch.autograd.DeviceType.CPU
                        for e in ours)
    for f, g in zip(frames, got):
        np.testing.assert_array_equal(g.cpu().numpy(), f)
    metrics.reset()
    stager.put(frames[0]).wait()
    torch.cuda.synchronize(dev)
    assert metrics.counters() == {} and metrics.span_totals() == {}


@pytest.mark.parametrize("lock", [None, 12.0])
def test_chunks_match_per_frame_on_the_card(dev, lock):
    """K steps as one CUDA graph replay give the per-frame steps' maps bit
    for bit (the same kernels on the same inputs), count K launches per
    replay and none at capture, and return states that later replays do
    not change; the output stacks are the graph's own buffers."""
    from slc_tpu_torch import streaming
    from slc_tpu_torch.dynamic import dynamic_step
    cfg, tables, frames, state = _moving_plane(dev, 96, 160, 12, cfg=_setup(
        96, 160, dev)[0])
    kw = dict(phase_lock=lock, lock_win_u=21, lock_win_v=9)
    wrapper = (kstep.dynamic_step_lock_cuda if lock
               else kstep.dynamic_step_open_cuda)
    dev_frames = torch.from_numpy(frames[1:]).to(dev)
    st, ref = state, []
    for f in dev_frames:
        st, res = dynamic_step(st, f, tables, cfg, **kw)
        ref.append(res)
    graph = streaming.chunk_graph(4, 96, 160, dev, tables, cfg,
                                  phase_lock=lock, lock_win_u=21,
                                  lock_win_v=9)   # capture only
    wrapper.launches = 0
    st, states, kept, bufs = state, [], [], set()
    for c in range(2):
        st, (zs, xs, ys) = streaming.chunk_step_xyz(
            st, dev_frames[4 * c:4 * c + 4], tables, cfg, graph=graph, **kw)
        bufs.add(zs.data_ptr())
        for j in range(4):
            for k, stack in (("z", zs), ("x", xs), ("y", ys)):
                assert torch.equal(stack[j], getattr(ref[4 * c + j], k))
        states.append(st)
        kept.append([t.clone() for t in (st.proj_u, st.strip_w,
                                         st.strip_b, st.z)])
    assert wrapper.launches == 8
    assert bufs == {graph.zs.data_ptr()}
    with pytest.raises(ValueError, match="captured for other"):
        streaming.chunk_step_xyz(st, dev_frames[:4], tables, cfg,
                                 graph=graph, phase_lock=lock, lock_win_u=19,
                                 lock_win_v=9)
    # Staged straight into the graph's frame stack: no copy in run().
    graph.frames.copy_(dev_frames[:4])
    _, (zs, _, _) = streaming.chunk_step_xyz(state, graph.frames, tables,
                                             cfg, graph=graph, **kw)
    assert all(torch.equal(zs[j], ref[j].z) for j in range(4))
    for s, k in zip(states, kept):
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in
                   zip((s.proj_u, s.strip_w, s.strip_b, s.z), k))
    assert torch.equal(_bits(states[-1].proj_u), _bits(ref[7].proj_u))
    got = [z for _, zs in streaming.stream_chunks(
        state, list(frames[1:]), tables, cfg, chunk=4, **kw)
        for z in zs.clone()]
    assert len(got) == 11
    assert all(torch.equal(_bits(a), _bits(r.z)) for a, r in zip(got, ref))


def test_chunked_run_matches_per_frame_on_the_card(dev, tmp_path):
    """run_replay(chunk=4) on the card writes the per-frame run's clouds
    bit for bit, with an anchor group splitting a chunk."""
    import os
    from slc_tpu_torch.io.dataset import (write_anchor_group,
                                          write_replay_dataset)
    from slc_tpu_torch.io.opencv_yaml import save_calibration
    from slc_tpu_torch.runner import run_replay
    cfg = SystemConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640,
                       gray_bits=5)
    calib = synthetic_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    scene = synth.render_static_scene(calib, cfg, synth.plane_surface(50.0),
                                      noise_sigma=1.0)
    frames, _, _ = synth.render_dynamic_sequence(
        calib, cfg, 14, z0=50.0, dz_per_frame=0.3, stripe_period=12,
        noise_sigma=1.0)
    root = str(tmp_path / "ds")
    write_replay_dataset(root, scene.gray_images, scene.phase_images,
                         frames, config_fields={"stripe_period": 12})
    asc = synth.render_static_scene(calib, cfg,
                                    synth.plane_surface(50.0 + 6 * 0.3),
                                    noise_sigma=1.0, seed=6)
    write_anchor_group(root, 6, asc.gray_images, asc.phase_images)
    save_calibration(os.path.join(root, "parameters.yml"), calib)
    for k in (1, 4):
        run_replay(root, os.path.join(root, "parameters.yml"),
                   str(tmp_path / f"c{k}"), cfg, device=dev, chunk=k,
                   out_format="npz")
    names = sorted(f for f in os.listdir(tmp_path / "c1")
                   if f.endswith(".npz"))
    assert len(names) == 14
    for name in names:
        a, b = (np.load(tmp_path / f"c{k}" / name) for k in (1, 4))
        for m in ("x", "y", "z"):
            assert np.array_equal(a[m].view(np.uint32), b[m].view(np.uint32))


# --- the lock window's median on the card (kernels/lock_window.py) ---

@pytest.fixture(scope="module")
def decoded_pu():
    """P of frame 0 as decode_first_frame gives it on the card at
    1024x1280 (the reference's rig, a tilted plane, noise 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from slc_tpu_torch.pipeline import decode_first_frame
    dev = torch.device("cuda", 0)
    cfg, calib, tables = _setup(1024, 1280, dev)
    scene = synth.render_static_scene(
        calib, cfg, synth.plane_surface(50.0, 0.01, -0.01), noise_sigma=1.0)
    res = decode_first_frame(torch.from_numpy(scene.gray_images).to(dev),
                             torch.from_numpy(scene.phase_images).to(dev),
                             tables, cfg)
    return res.proj_u.cpu().numpy()


def _with_parity(parity):
    """A ragged random map whose count of valid pixels has ``parity``."""
    for seed in range(100):
        rng = np.random.default_rng(seed)
        pu = np.cumsum(rng.uniform(0.0, 1.0, (45, 77)), 1)
        pu[rng.uniform(size=pu.shape) < 0.1] = 0.0
        pu = pu.astype(np.float32)
        if klw.middle_abs_gradients_ref(pu)[0] % 2 == parity:
            return pu
    raise AssertionError("no map of that parity")


def _lock_map(case, decoded):
    """The map of a lock-window case, float32 on the host."""
    rng = np.random.default_rng(3)
    pu = decoded
    if case == "holes":
        pu = pu.copy()
        pu[rng.uniform(size=pu.shape) < 0.05] = 0.0
    elif case == "left_zero":
        pu = pu.copy()
        pu[:, :400] = 0.0
    elif case == "mirrored":                  # negative gradients
        pu = np.ascontiguousarray(pu[:, ::-1])
    elif case == "ties":                      # few distinct gradients
        u = np.arange(pu.shape[1], dtype=np.float32)
        pu = np.tile(0.5 * u + 1.0, (pu.shape[0], 1))
        pu[::3] = 0.75 * u + 1.0
        pu[rng.uniform(size=pu.shape) < 0.01] = 0.0
    elif case in ("even", "odd"):
        pu = _with_parity(case == "odd")
    elif case == "none":                      # nothing valid: median 1.0
        pu = np.full((90, 150), -1.0, np.float32)
    elif case == "ragged":
        pu = np.cumsum(rng.uniform(0.3, 0.9, (90, 150)), 1)
        pu = pu.astype(np.float32)
    return pu.astype(np.float32)


def _f64_bits(x):
    return np.float64(x).view(np.int64)


@pytest.mark.parametrize("case,periods", [
    ("decoded", (12.0, 20.0, 200.0)), ("holes", (12.0,)),
    ("left_zero", (12.0, 20.0)), ("mirrored", (12.0,)), ("ties", (12.0,)),
    ("even", (12.0,)), ("odd", (12.0,)), ("none", (12.0,)),
    ("ragged", (12.0, 200.0))])
def test_lock_window_median_on_the_card(dev, decoded_pu, case, periods):
    """The kernel's n and two middle values equal numpy's; the median
    taken from them equals np.median bit for bit; the window equals the
    host path's, from a card tensor and from an uploaded float32 map."""
    from slc_tpu_torch.ops import demod
    pu = _lock_map(case, decoded_pu)
    got = klw.middle_abs_gradients(torch.from_numpy(pu).to(dev))
    assert got == klw.middle_abs_gradients_ref(pu)
    n, lo, hi = got
    a = klw.valid_abs_gradients(pu)
    assert a.size == n and (case != "none" or n == 0)
    want = float(np.median(a)) if n else 1.0
    assert _f64_bits(np.mean([lo, hi]) if n else 1.0) == _f64_bits(want)
    if case in ("even", "odd"):
        assert n % 2 == (case == "odd") and (case == "even" or lo == hi)
    for period in periods:
        host = demod.suggest_lock_window(pu.astype(np.float64), period)
        assert demod.suggest_lock_window(torch.from_numpy(pu).to(dev),
                                         period) == host
        assert demod.suggest_lock_window(pu, period) == host


def test_lock_window_rounds_half_to_even_on_the_card(dev):
    """A constant gradient of 0.5 with period 10.25 puts T / med on 20.5,
    which Python's round takes to 20 (window 19); half up would give 21."""
    from slc_tpu_torch.ops import demod
    u = np.arange(150, dtype=np.float32)
    pu = np.tile(0.5 * u + 1.0, (90, 1))
    n, lo, hi = klw.middle_abs_gradients(torch.from_numpy(pu).to(dev))
    assert n == 88 * 148 and lo == hi == 0.5
    assert demod.suggest_lock_window(torch.from_numpy(pu).to(dev),
                                     10.25) == 19
    assert demod.suggest_lock_window(pu.astype(np.float64), 10.25) == 19


def test_lock_window_counts_card_calls(dev):
    """A call on the card launches the kernel's wrapper once; under a
    profiler it counts ``setup.lock_window_card`` once and times its
    span; without one it records nothing. The launches are capturable
    (no wait), as its timing in a CUDA graph needs."""
    from slc_tpu_torch import metrics
    from slc_tpu_torch.ops import demod
    pu = torch.from_numpy(_lock_map("ragged", None)).to(dev)
    klw.middle_abs_gradients_cuda.launches = 0
    metrics.reset()
    win = demod.suggest_lock_window(pu, 12.0)
    assert klw.middle_abs_gradients_cuda.launches == 1
    assert metrics.counters() == {} and metrics.span_totals() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert demod.suggest_lock_window(pu, 12.0) == win
    assert metrics.counters() == {"setup.lock_window_card": 1}
    assert metrics.span_totals()["setup.lock_window"]["calls"] == 1
    metrics.reset()
    assert devtime.graph_time_s(
        lambda: klw.middle_abs_gradients_cuda(pu), n=2, warmup=1) > 0
