"""Plain PyTorch reference of the two decodes and the locked tracker.

A frozen copy of the port's plain versions (``slc_tpu_torch/ops/*.py``,
``kernels/grayphase.py:grayphase_decode_ref``,
``kernels/heterodyne.py:heterodyne_decode_ref``,
``kernels/dynamic_step.py:dynamic_step_lock_ref``, ``calib.build_tables``,
``ops/demod.suggest_lock_window``), with the formulas of the reference
C++ program they cite (DynaFrame/CCalculation.cpp, CDecodeGray.cpp,
CDecodePhase.cpp). Every floating-point operation runs in ``dt``:
float32 is the configurations' stated precision, bfloat16 the control's.
Integer work (Gray bits, box sums of u8 rows) stays integer, as it is
exact in every precision.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

TWO_PI = 2.0 * math.pi
#: Row-band height of the lock's carrier-consistency gate.
GATE_BAND = 64
#: The lock's amplitude floor and carrier-gradient gate (dynamic_step's
#: defaults, which the timed path keeps).
AMP_FLOOR = 8.0
MAX_CARRIER_GRADIENT = 2e-3


# --- calibration ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tables:
    """Per-pixel rational triangulation z = (B P - A) / (C - D P)
    (CCalculation.cpp:135-166, 686-687), float32 on ``device``."""
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor


def pro_mat(cal: Dict[str, np.ndarray]) -> np.ndarray:
    """3x4 projector projection K_p [R | T] in float64
    (CCalculation.cpp:141-145)."""
    rt = np.concatenate([np.asarray(cal["rot"], np.float64),
                         np.asarray(cal["trans"], np.float64).reshape(3, 1)],
                        axis=1)
    return np.asarray(cal["pro_k"], np.float64) @ rt


def build_tables(cal: Dict[str, np.ndarray], h: int, w: int,
                 device) -> Tables:
    """Float64 host construction, normalised by fx*fy, rounded to
    float32 once."""
    k = np.asarray(cal["cam_k"], np.float64)
    p = pro_mat(cal)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    u = np.arange(w, dtype=np.float64)[None, :] - cx
    v = np.arange(h, dtype=np.float64)[:, None] - cy
    norm = fx * fy
    c = (u * fy * p[0, 0] + v * fx * p[0, 1]) / norm + p[0, 2]
    d = (u * fy * p[2, 0] + v * fx * p[2, 1]) / norm + p[2, 2]

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)
    return Tables(a=f32(p[0, 3]), b=f32(p[2, 3]),
                  c=f32(np.broadcast_to(c, (h, w))),
                  d=f32(np.broadcast_to(d, (h, w))))


def triangulate_depth(pu: torch.Tensor, t: Tables, fov: Tuple[float, float],
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P == 0 is a hole; z outside [fov_min, fov_max] is 0
    (CCalculation.cpp:678-704)."""
    dt = pu.dtype
    denom = t.c.to(dt) - t.d.to(dt) * pu
    z = (t.b.to(dt) * pu - t.a.to(dt)) / denom
    hole = pu == 0
    if valid is not None:
        hole = hole | ~valid
    out = (z < fov[0]) | (z > fov[1])
    return torch.where(hole | out, torch.zeros_like(z), z)


# --- Gray + phase decode ----------------------------------------------

def gray_bins(images: torch.Tensor, bits: int) -> torch.Tensor:
    """Pattern > inverse per bit, LSB first, Gray to binary by an XOR
    prefix scan (CDecodeGray.cpp:150-204)."""
    g = torch.zeros(images.shape[1:], dtype=torch.int32,
                    device=images.device)
    for k in range(bits):
        bit = images[2 * k] > images[2 * k + 1]
        g = g | (bit.to(torch.int32) << k)
    b, shift = g, 1
    while shift < bits:
        b = b ^ (b >> shift)
        shift <<= 1
    return b


def phase_sincos(images: torch.Tensor, dt) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(B sin phi, B cos phi) of an N-step stack (CDecodePhase.cpp:48-66),
    the step coefficients float32 cos/sin of the float32 step angle."""
    n = images.shape[0]
    k = torch.arange(n, dtype=torch.float32, device=images.device) \
        * (2.0 * math.pi / n)
    shape = (n, 1, 1)
    imgs = images.to(dt)
    s = (imgs * torch.cos(k).to(dt).reshape(shape)).sum(0) * (2.0 / n)
    c = (imgs * torch.sin(k).to(dt).reshape(shape)).sum(0) * (2.0 / n)
    return s, c


def decode_phase(images: torch.Tensor, period: float, dt) -> torch.Tensor:
    """Wrapped projector offset in (0, T] (CDecodePhase.cpp:67-74)."""
    s, c = phase_sincos(images, dt)
    ang = torch.atan2(s, c)
    ang = torch.where(ang < 0, ang + TWO_PI, ang)
    scale = float(np.float32(period) / np.float32(TWO_PI))
    pix = ang * scale + 0.5
    return torch.where(pix > period, pix - period, pix)


def modulation(images: torch.Tensor, dt) -> torch.Tensor:
    s, c = phase_sincos(images, dt)
    return torch.sqrt(s * s + c * c)


def decode_grayphase(gray: torch.Tensor, phase: torch.Tensor, t: Tables,
                     sysc: dict, dt=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-0 absolute decode (CCalculation.cpp:525-592) and its depth:
    returns (z, P)."""
    bits, pro_w = sysc["gray_bits"], sysc["pro_w"]
    gp = pro_w / (1 << bits)
    tp = pro_w // (1 << (bits - 1))
    coord = gray_bins(gray, bits).to(dt) * gp
    ph = decode_phase(phase, tp, dt)
    t_ = float(tp)
    even = ((coord / gp).to(torch.int32) % 2) == 0
    ph_even = torch.where(ph > 0.75 * t_, ph - t_, ph)
    ph_odd = torch.where(ph < 0.25 * t_, ph + t_, ph) - 0.5 * t_
    pu = coord + torch.where(even, ph_even, ph_odd)
    z = triangulate_depth(pu, t, (sysc["fov_min"], sysc["fov_max"]))
    return z, pu


# --- heterodyne decode ------------------------------------------------

def beat_periods(periods: Sequence[float], extent: float
                 ) -> Tuple[list, float]:
    level = [float(p) for p in periods]
    spine = []
    while len(level) > 1:
        spine.append(level[0])
        level = [level[i] * level[i + 1] / abs(level[i + 1] - level[i])
                 for i in range(len(level) - 1)]
    if level[0] < extent - 1e-6:
        raise ValueError(f"heterodyne cascade reaches only {level[0]:.1f} "
                         f"px of {extent}")
    return spine, level[0]


def decode_heterodyne(images: torch.Tensor, t: Tables, sysc: dict,
                      counts: Sequence[int], steps: int,
                      min_modulation: Optional[float] = 2.0,
                      dt=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-frequency heterodyne decode, finest frequency first: the
    beat cascade up to one period over the projector width, then fringe
    orders back down the left spine; pixels whose smallest modulation is
    not above ``min_modulation`` are holes. Returns (z, P)."""
    pro_w = float(sysc["pro_w"])
    periods = [sysc["pro_w"] / n for n in counts]
    stacks = [images[i * steps:(i + 1) * steps] for i in range(len(counts))]
    wrapped = [decode_phase(s, float(p), dt) for s, p in zip(stacks, periods)]
    spine, coarse = beat_periods(periods, pro_w)
    fracs = [wrapped[i] / float(p) for i, p in enumerate(periods)]
    spine_fracs = []
    while len(fracs) > 1:
        spine_fracs.append(fracs[0])
        nxt = []
        for i in range(len(fracs) - 1):
            d = fracs[i] - fracs[i + 1]
            nxt.append(d - torch.floor(d))
        fracs = nxt
    x = fracs[0] * coarse
    for u, p in zip(reversed(spine_fracs), reversed(spine)):
        k = torch.round(x / p - u)
        x = (k + u) * p
    pu = x - pro_w * torch.floor(x / pro_w)
    valid = None
    if min_modulation is not None:
        mod = modulation(stacks[0], dt)
        for s in stacks[1:]:
            mod = torch.minimum(mod, modulation(s, dt))
        valid = mod > min_modulation
        pu = torch.where(valid, pu, torch.zeros_like(pu))
    z = triangulate_depth(pu, t, (sysc["fov_min"], sysc["fov_max"]), valid)
    return z, pu


# --- stripe tracking --------------------------------------------------

def _interior(h, w, r, device):
    row = torch.arange(h, device=device)[:, None]
    col = torch.arange(w, device=device)[None, :]
    return (row >= r) & (row < h - r) & (col >= r) & (col < w - r)


def box_sum_vertical(frame: torch.Tensor, window: int, dt) -> torch.Tensor:
    """Vertical box sum of ``window`` rows in int32, the border zeroed
    (CCalculation.cpp:797-823)."""
    h, w = frame.shape
    r = window // 2
    fp = F.pad(frame.to(torch.int32), (0, 0, r, r))
    s = torch.cat([torch.zeros((1, w), dtype=torch.int32,
                               device=frame.device),
                   torch.cumsum(fp, 0, dtype=torch.int32)], 0)
    box = (s[window:] - s[:-window]).to(dt)
    return torch.where(_interior(h, w, r, frame.device), box,
                       torch.zeros_like(box))


def windowed_extrema(val: torch.Tensor, window: int, subpixel: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offsets of the max and min over [-r, r), the centre winning ties,
    else the leftmost (CCalculation.cpp:828-891); ``subpixel`` refines
    each by a parabola through its neighbours, clamped to +-0.5."""
    h, w = val.shape
    r = window // 2

    def rolled(i):
        return torch.roll(val, -i, dims=1)

    bmax, bmin = val, val
    imax = torch.zeros_like(val)
    imin = torch.zeros_like(val)
    if subpixel:
        max_vm = min_vm = rolled(-1)
        max_vp = min_vp = rolled(1)
    v_prev, v = rolled(-r - 1), rolled(-r)
    for i in range(-r, r):
        v_next = rolled(i + 1)
        up = v > bmax
        bmax = torch.where(up, v, bmax)
        imax = torch.where(up, float(i), imax)
        dn = v < bmin
        bmin = torch.where(dn, v, bmin)
        imin = torch.where(dn, float(i), imin)
        if subpixel:
            max_vm = torch.where(up, v_prev, max_vm)
            max_vp = torch.where(up, v_next, max_vp)
            min_vm = torch.where(dn, v_prev, min_vm)
            min_vp = torch.where(dn, v_next, min_vp)
        v_prev, v = v, v_next
    if subpixel:
        def refine(idx, v0, vm, vp):
            den = vm - 2.0 * v0 + vp
            frac = torch.where(den.abs() > 1e-6, 0.5 * (vm - vp) / den,
                               torch.zeros_like(den)).clamp(-0.5, 0.5)
            return idx + frac
        imax = refine(imax, bmax, max_vm, max_vp)
        imin = refine(imin, bmin, min_vm, min_vp)
    inside = _interior(h, w, r, val.device)
    zero = torch.zeros_like(val)
    return torch.where(inside, imax, zero), torch.where(inside, imin, zero)


def stripe_regression(frame: torch.Tensor, window: int, subpixel: bool,
                      dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """(strip_w, strip_b) of one frame (CCalculation.cpp:789-891)."""
    return windowed_extrema(box_sum_vertical(frame, window, dt), window,
                            subpixel)


def box_blur_3x3(x: torch.Tensor) -> torch.Tensor:
    """cv::blur 3x3 with REFLECT_101 borders, rows then columns, the taps
    added directly (CCalculation.cpp:648-650)."""
    h, w = x.shape
    pad = F.pad(x[None, None], (0, 0, 1, 1), mode="reflect")[0, 0]
    x = pad[0:h] + pad[1:h + 1] + pad[2:h + 2]
    pad = F.pad(x[None, None], (1, 1, 0, 0), mode="reflect")[0, 0]
    x = pad[:, 0:w] + pad[:, 1:w + 1] + pad[:, 2:w + 2]
    return x / 9.0


def select_delta_p(sw0, sb0, sw1, sb1, robust: bool) -> torch.Tensor:
    """The stripe family that moved less; with ``robust`` the mean where
    both agree within 1 px (CCalculation.cpp:595-646)."""
    d_b = sb0 - sb1
    d_w = sw0 - sw1
    m = torch.where(d_b.abs() < d_w.abs(), d_b, d_w)
    if not robust:
        return m
    return torch.where((d_b - d_w).abs() <= 1.0, 0.5 * (d_b + d_w), m)


# --- the phase lock ---------------------------------------------------

def _box_sum_1d(x: torch.Tensor, win: int, dim: int) -> torch.Tensor:
    r = win // 2
    rr = win - 1 - r
    n = x.shape[dim]
    pad = (r, rr, 0, 0) if dim == 1 else (0, 0, r, rr)
    s = torch.cumsum(F.pad(x, pad), dim)
    zs = list(x.shape)
    zs[dim] = 1
    s = torch.cat([torch.zeros(zs, dtype=x.dtype, device=x.device), s], dim)
    return s.narrow(dim, win, n) - s.narrow(dim, 0, n)


def _tri_sum(x, win_v, win_u):
    x = _box_sum_1d(_box_sum_1d(x, win_u, 1), win_u, 1)
    return _box_sum_1d(_box_sum_1d(x, win_v, 0), win_v, 0)


def _tri_weight(h, w, win_v, win_u, device, dt):
    def one(n, win):
        ones = torch.ones((1, n), dtype=torch.float32, device=device)
        return _box_sum_1d(_box_sum_1d(ones, win, 1), win, 1)[0]
    return (one(h, win_v)[:, None] * one(w, win_u)[None, :]).to(dt)


def _wrap(x):
    return x - TWO_PI * torch.round(x / TWO_PI)


def lock_correction(frame: torch.Tensor, pred: torch.Tensor, period: float,
                    win_u: int, win_v: int, dt) -> torch.Tensor:
    """Lock-in demodulation of the stripe frame against the predicted map
    with a triangle low-pass, each pixel refined by its arccos reading
    nearer the window-corrected prediction, gated by amplitude and by the
    carrier gradient of each 64-row band. Returns the additive P
    correction."""
    h, w = frame.shape
    f = frame.to(dt)
    wgt = _tri_weight(h, w, win_v, win_u, frame.device, dt)
    dc = _tri_sum(f, win_v, win_u) / wgt
    iac = f - dc
    phi = (TWO_PI / period) * pred
    c = _tri_sum(iac * torch.cos(phi), win_v, win_u)
    s = _tri_sum(iac * torch.sin(phi), win_v, win_u)
    amp = torch.sqrt(c * c + s * s) / wgt
    dphi = torch.atan2(-s, c)
    cos_phi = (iac / torch.clamp(2.0 * amp, min=1e-6)).clamp(-1.0, 1.0)
    mag = torch.arccos(cos_phi)
    ref = phi + dphi
    d_pos = _wrap(mag - ref)
    d_neg = _wrap(-mag - ref)
    conf = 1.0 - cos_phi * cos_phi
    d_px = torch.where(d_pos.abs() <= d_neg.abs(), d_pos, d_neg)
    delta_p = (dphi + conf * d_px) * (period / TWO_PI)
    ok = (amp > AMP_FLOOR) & (pred > 0)
    gx = _wrap(dphi[:, 1:] - dphi[:, :-1])
    gm = (ok[:, 1:] & ok[:, :-1]).to(dt)
    hb = -(-h // GATE_BAND) * GATE_BAND

    def band_sum(x):
        xp = F.pad(x, (0, 0, 0, hb - h))
        return xp.reshape(hb // GATE_BAND, GATE_BAND, -1).sum((1, 2))
    g = band_sum(gx * gm) / torch.clamp(band_sum(gm), min=1.0)
    gate = g.abs() <= MAX_CARRIER_GRADIENT
    ok = ok & torch.repeat_interleave(gate, GATE_BAND)[:h][:, None]
    return torch.where(ok, delta_p, torch.zeros_like(delta_p))


# --- the tracker ------------------------------------------------------

@dataclasses.dataclass
class Tracker:
    """The reference's carried state: P, the strips of the last frame,
    and the lock's window, worked out from frame 0."""
    pu: torch.Tensor
    sw: torch.Tensor
    sb: torch.Tensor
    win_u: int


def suggest_lock_window(pu0: np.ndarray, period: float,
                        max_window: int = 64) -> int:
    """T / median |dP/du| over the frame-0 map, odd, in [3, max_window]."""
    pu = np.asarray(pu0, np.float64)
    g = 0.5 * (np.roll(pu, -1, axis=1) - np.roll(pu, 1, axis=1))
    g = g[1:-1, 1:-1]
    valid = (pu[1:-1, 1:-1] > 0) & (np.abs(g) > 1e-3)
    med = float(np.median(np.abs(g[valid]))) if valid.any() else 1.0
    win = int(np.clip(int(round(period / max(med, 1e-3))), 3, max_window))
    return win if win % 2 else win - 1


def init_tracker(frame0: torch.Tensor, pu0: torch.Tensor, sysc: dict,
                 track: dict, period: float) -> Tracker:
    sw, sb = stripe_regression(frame0, sysc["reco_window"],
                               track["subpixel"], pu0.dtype)
    win = suggest_lock_window(pu0.float().cpu().numpy(), period)
    return Tracker(pu=pu0, sw=sw, sb=sb, win_u=win)


def locked_step(st: Tracker, frame: torch.Tensor, t: Tables, sysc: dict,
                track: dict, period: float, win_v: int
                ) -> Tuple[Tracker, torch.Tensor]:
    """One locked tracker step (CCalculation.cpp:221-316 with the lock):
    track, select, 3x3 mean, gradient scale, integrate, lock, triangulate.
    Returns the new state and z."""
    dt = st.pu.dtype
    window = sysc["reco_window"]
    sw, sb = stripe_regression(frame, window, track["subpixel"], dt)
    dp = box_blur_3x3(select_delta_p(st.sw, st.sb, sw, sb, track["robust"]))
    if track["scale_gradient"]:
        g = 0.5 * (torch.roll(st.pu, -1, dims=1) - torch.roll(st.pu, 1, dims=1))
        dp = dp * g.clamp(0.2, 5.0)
    pu = st.pu + dp
    pu = pu + lock_correction(frame, pu, period, st.win_u, win_v, dt)
    z = triangulate_depth(pu, t, (sysc["fov_min"], sysc["fov_max"]))
    return Tracker(pu=pu, sw=sw, sb=sb, win_u=st.win_u), z
