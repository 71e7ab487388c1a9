"""The route of the registration's point-to-plane step, on the CPU.

``fusion._gn_step_p2l`` runs the hand-written kernels of
``slc_tpu_torch.kernels.p2l`` for tensors off the CPU with no
``reduce_fn``, and its plain code elsewhere. Here: CPU tensors and any
``reduce_fn`` take the plain code (the kernel's wrapper replaced by one
that fails), tensors off the CPU (``meta`` tensors stand in for the card's)
take the wrapper, with one scratch a ``_fuse_scans_p2l`` call; the plain
code is bit for bit the formula it had before the kernels (a copy below);
on the CPU ``fusion.gn_steps`` counts every step and ``fusion.p2l_kernel``
none; the wrapper refuses what the kernels do not take before any build.
The kernels themselves are held to the plain step on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from slc_tpu_torch import fusion, metrics, se3
from slc_tpu_torch.kernels import p2l as kp2l

CPU = [torch.profiler.ProfilerActivity.CPU]


def _parent_gn_terms_p2l(rot, trans, landmarks, normals, obs, mask, center):
    ry = torch.einsum("sij,slj->sli", rot, obs)
    pred = ry + trans[:, None, :]
    e = torch.einsum("lk,slk->sl", normals, pred - landmarks[None]) * mask
    mean_abs = e.abs().sum() / mask.sum().clamp_min(1.0)
    delta = 3.0 * mean_abs + 1e-6
    w_rob = torch.sqrt(torch.clamp_max(delta / (e.abs() + 1e-12), 1.0))
    e = e * w_rob
    lever = pred - center[:, None, :]
    n_b = normals[None].expand(ry.shape)
    j = torch.cat([n_b, -torch.linalg.cross(n_b, lever, dim=-1)], dim=-1)
    j = j * (mask * w_rob)[..., None]
    h_cc = torch.einsum("sli,slj->sij", j, j)
    b_c = -torch.einsum("sli,sl->si", j, e)
    return h_cc, b_c, e


def _parent_gn_step_p2l(rot, trans, landmarks, normals, obs, mask,
                        damping, reduce_fn=None):
    """The point-to-plane step as it was before the kernels, verbatim."""
    red = reduce_fn if reduce_fn is not None else (lambda x: x)
    pred = torch.einsum("sij,slj->sli", rot, obs) + trans[:, None, :]
    csum = red((pred * mask[..., None]).sum(dim=1))
    nobs = red(mask.sum(dim=1)).clamp_min(1.0)
    center = csum / nobs[:, None]
    h_cc, b_c, _ = _parent_gn_terms_p2l(rot, trans, landmarks, normals, obs,
                                        mask, center)
    h_cc, b_c = red(h_cc), red(b_c)
    diag_cc = torch.einsum("sii->si", h_cc)
    eye6 = torch.eye(6, dtype=h_cc.dtype, device=h_cc.device)
    lm_term = damping * torch.diag_embed(diag_cc) + 1e-9 * eye6
    delta_c, info = torch.linalg.solve_ex(h_cc + lm_term, b_c[..., None])
    delta_c = delta_c[..., 0]
    delta_c[0] = 0.0
    d_rot, d_t = se3.exp_se3(delta_c)
    new_trans = (torch.einsum("sij,sj->si", d_rot, trans - center)
                 + center + d_t)
    return d_rot @ rot, new_trans, landmarks, info.sum()


def _problem(seed=3, s=5, l=300):
    """A seeded ``synthetic_problem`` with noisy observations, random unit
    normals, landmarks from view 0 and perturbed initial poses, as
    (rot, trans, landmarks, normals, obs, mask) on the CPU."""
    rng = np.random.default_rng(seed)
    obs, mask, rot_gt, trans_gt = fusion.synthetic_problem(
        rng, s=s, l=l, noise=0.01, device="cpu")
    n = rng.normal(size=(l, 3)).astype(np.float32)
    normals = torch.from_numpy(n / np.linalg.norm(n, axis=1, keepdims=True))
    landmarks = (torch.einsum("ij,lj->li", rot_gt[0], obs[0])
                 + trans_gt[0])
    turn = torch.stack([se3.exp_so3(torch.from_numpy(
        rng.normal(0, 0.01, 3).astype(np.float32))) for _ in range(s)])
    trans = trans_gt + torch.from_numpy(
        rng.normal(0, 0.1, (s, 3)).astype(np.float32))
    return turn @ rot_gt, trans, landmarks, normals, obs, mask


def _no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernels were called")
    monkeypatch.setattr(kp2l, "gn_step_p2l_cuda", refuse)
    monkeypatch.setattr(kp2l, "P2LWork", refuse)


@pytest.mark.parametrize("seed", [3, 11])
def test_the_plain_step_is_the_parents_formula(monkeypatch, seed):
    """On the CPU the step, one or several, is the parent's formula bit
    for bit, and never touches the kernels."""
    _no_kernel(monkeypatch)
    rot, trans, lm, nrm, obs, mask = _problem(seed)
    with fusion.full_f32():
        want = _parent_gn_step_p2l(rot, trans, lm, nrm, obs, mask, 1e-3)
        got = fusion._gn_step_p2l(rot, trans, lm, nrm, obs, mask, 1e-3)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        r, t = rot, trans
        for _ in range(4):
            r, t, _, _ = _parent_gn_step_p2l(r, t, lm, nrm, obs, mask, 1e-3)
    got = fusion.fuse_scans_p2l(obs, mask, nrm, rot, trans, lm, iters=4)
    assert torch.equal(got[0], r) and torch.equal(got[1], t)
    assert torch.equal(got[2], lm)


def test_any_reduce_fn_takes_the_plain_step(monkeypatch):
    """A shard reduction keeps the plain step, on the CPU and off it
    (``meta`` tensors stand in for the card's)."""
    _no_kernel(monkeypatch)
    rot, trans, lm, nrm, obs, mask = _problem()
    calls = []

    def ident(x):
        calls.append(tuple(x.shape))
        return x
    with fusion.full_f32():
        got = fusion._gn_step_p2l(rot, trans, lm, nrm, obs, mask, 1e-3,
                                  ident)
        want = _parent_gn_step_p2l(rot, trans, lm, nrm, obs, mask, 1e-3,
                                   ident)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        meta = [a.to("meta") for a in (rot, trans, lm, nrm, obs, mask)]
        out = fusion._gn_step_p2l(*meta, 1e-3, ident)
    assert calls and out[0].device.type == "meta"
    assert not fusion._p2l_kernel_route(meta[4], ident)
    assert fusion._p2l_kernel_route(meta[4])
    assert not fusion._p2l_kernel_route(obs)


class _FakeWork:
    made = []

    def __init__(self, views, landmarks, device):
        self.views, self.landmarks, self.device = views, landmarks, device
        self.info = torch.zeros((), dtype=torch.int64, device=device)
        _FakeWork.made.append(self)


def test_tensors_off_the_cpu_take_the_kernels(monkeypatch):
    """Off the CPU with no reduce_fn every step goes to the kernels'
    wrapper: a single step makes its own scratch, a ``_fuse_scans_p2l``
    call one for all its steps, whose codes it returns, and each of its
    steps counts 1 under ``fusion.p2l_kernel``."""
    steps = []

    def wrapper(rot, trans, landmarks, normals, obs, mask, damping, work):
        steps.append(work)
        return rot + 1.0, trans + 1.0
    monkeypatch.setattr(kp2l, "gn_step_p2l_cuda", wrapper)
    monkeypatch.setattr(kp2l, "P2LWork", _FakeWork)
    _FakeWork.made = []
    meta = [a.to("meta") for a in _problem(s=4, l=50)]
    rot, trans, lm, nrm, obs, mask = meta
    out = fusion._gn_step_p2l(rot, trans, lm, nrm, obs, mask, 1e-3)
    assert len(steps) == 1 and len(_FakeWork.made) == 1
    assert (_FakeWork.made[0].views, _FakeWork.made[0].landmarks) == (4, 50)
    assert out[2] is lm and out[3] is _FakeWork.made[0].info
    metrics.reset()
    with torch.profiler.profile(activities=CPU):
        got = fusion._fuse_scans_p2l(obs, mask, nrm, rot, trans, lm, 5, 1e-3)
    assert len(steps) == 6 and len(_FakeWork.made) == 2
    assert all(w is _FakeWork.made[1] for w in steps[1:])
    assert got[3] is _FakeWork.made[1].info
    assert metrics.counters() == {"fusion.gn_steps": 5,
                                  "fusion.p2l_kernel": 5}


def test_on_the_cpu_the_steps_count_and_none_is_the_kernels(monkeypatch):
    _no_kernel(monkeypatch)
    rot, trans, lm, nrm, obs, mask = _problem()
    metrics.reset()
    with torch.profiler.profile(activities=CPU):
        fusion.fuse_scans_p2l(obs, mask, nrm, rot, trans, lm, iters=3)
        fusion.fuse_scans_p2l(obs, mask, nrm, rot, trans, lm, iters=2)
    assert metrics.counters() == {"fusion.gn_steps": 5,
                                  "fusion.p2l_kernel": 0}


@pytest.mark.parametrize("views,landmarks,sms,want", [
    (16, 81920, 132, 17), (4, 64, 132, 1), (3, 1001, 132, 4),
    (4, 4096, 132, 16), (1, 10 ** 6, 132, 264), (200, 81920, 132, 2)])
def test_blocks_per_view(views, landmarks, sms, want):
    """About two blocks an SM shared among the views, no more than a
    view's landmarks fill, at least one."""
    assert kp2l.blocks_per_view(views, landmarks, sms) == want


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    """CPU tensors (``meta`` ones too) and a mask that is not (S, L)
    raise before anything is built or launched."""
    rot, trans, lm, nrm, obs, mask = _problem(s=4, l=50)
    work = _FakeWork(4, 50, "cpu")
    with pytest.raises(ValueError, match="cuda tensors"):
        kp2l.gn_step_p2l_cuda(rot, trans, lm, nrm, obs, mask, 1e-3, work)
    with pytest.raises(ValueError, match="non-empty"):
        kp2l.gn_step_p2l_cuda(rot, trans, lm, nrm, obs, mask[0], 1e-3, work)
    meta = [a.to("meta") for a in (rot, trans, lm, nrm, obs, mask)]
    with pytest.raises(ValueError, match="cuda tensors"):
        kp2l.gn_step_p2l_cuda(*meta, 1e-3, work)
