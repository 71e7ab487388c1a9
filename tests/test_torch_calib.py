"""slc_tpu_torch.calib and ops.triangulate against slc_tpu on the same
inputs: tables and bilinear coefficients bit-identical, xyz to 1e-5."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import calib as jcalib
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig
from slc_tpu.io import opencv_yaml as jyaml
from slc_tpu.ops.triangulate import triangulate_xyz as j_triangulate_xyz
from slc_tpu.pallas.mathx import lin_coeffs as j_lin_coeffs

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch.io import opencv_yaml as tyaml
from slc_tpu_torch.ops.triangulate import triangulate_xyz

torch.set_num_threads(2)

_FIELDS = ("a", "b", "c", "d", "fx", "fy", "cx", "cy")


def _calibs(h, w):
    return {
        "synthetic": (jcalib.synthetic_calibration(cam_h=h, cam_w=w,
                                                   pro_h=96, pro_w=640),
                      tcalib.synthetic_calibration(cam_h=h, cam_w=w,
                                                   pro_h=96, pro_w=640)),
        "reference": (jcalib.Calibration.reference_example(),
                      tcalib.Calibration.reference_example()),
    }


@pytest.mark.parametrize("shape", [(96, 160), (90, 150)])
@pytest.mark.parametrize("which", ["synthetic", "reference"])
def test_calibration_and_tables_bit_identical(shape, which):
    h, w = shape
    jc, tc = _calibs(h, w)[which]
    for f in ("cam_k", "pro_k", "rot", "trans"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    np.testing.assert_array_equal(tc.pro_mat(), jc.pro_mat())
    jt = jcalib.build_tables(jc, h, w)
    tt = tcalib.build_tables(tc, h, w, device="cpu")
    for f in _FIELDS:
        got = getattr(tt, f).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(getattr(jt, f)))


@pytest.mark.parametrize("which", ["synthetic", "reference"])
def test_lin_coeffs_bit_identical(which):
    h, w = 96, 160
    jc, tc = _calibs(h, w)[which]
    jt = jcalib.build_tables(jc, h, w)
    tt = tcalib.build_tables(tc, h, w, device="cpu")
    want = [np.float32(v) for m in (jt.c, jt.d) for v in j_lin_coeffs(m)]
    got = [np.float32(v) for v in tt.coeffs[6:]]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.float32(tt.coeffs[:6]),
        [np.float32(np.asarray(getattr(jt, f)))
         for f in ("a", "b", "fx", "fy", "cx", "cy")])


def test_tables_from_numpy_roundtrip():
    jc = jcalib.synthetic_calibration(cam_h=96, cam_w=160)
    jt = jcalib.build_tables(jc, 96, 160)
    tt = tcalib.TriangulationTables.from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in _FIELDS}, device="cpu")
    ref = tcalib.build_tables(
        tcalib.Calibration.from_numpy(*(np.asarray(getattr(jc, f)) for f in
                                        ("cam_k", "pro_k", "rot", "trans"))),
        96, 160, device="cpu")
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      getattr(ref, f).numpy())
    assert tt.coeffs == ref.coeffs


@pytest.mark.parametrize("shape", [(96, 160), (90, 150)])
def test_triangulate_xyz_matches_jax(rng, shape):
    h, w = shape
    jc, tc = _calibs(h, w)["synthetic"]
    jt = jcalib.build_tables(jc, h, w)
    tt = tcalib.build_tables(tc, h, w, device="cpu")
    # The projector map of a rendered sphere (a well-conditioned
    # denominator, as every real map has), with a band of holes.
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=96, pro_w=640, gray_bits=5)
    _, pu = jsynth.surface_geometry(jc, cfg, jsynth.sphere_surface())
    pu = pu.astype(np.float32)
    pu[:, 10:14] = 0.0                          # holes stay holes
    valid = rng.uniform(size=(h, w)) > 0.1
    for v in (None, valid):
        want = j_triangulate_xyz(jnp.asarray(pu), jt, 10.0, 100.0,
                                 None if v is None else jnp.asarray(v))
        got = triangulate_xyz(torch.from_numpy(pu), tt, 10.0, 100.0,
                              None if v is None else torch.from_numpy(v))
        for g, e in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5)
        assert (got[2].numpy()[:, 10:14] == 0).all()


def test_synthetic_calibration_defaults_identical():
    jc = jcalib.synthetic_calibration()
    tc = tcalib.synthetic_calibration()
    for f in ("cam_k", "pro_k", "rot", "trans"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)))


def test_yaml_round_trip_across_packages(tmp_path):
    """A calibration file either package writes loads bit-identically in
    the other."""
    jc = jcalib.Calibration.reference_example()
    tc = tcalib.Calibration.reference_example()
    pj = os.path.join(tmp_path, "jax.yml")
    pt = os.path.join(tmp_path, "torch.yml")
    jyaml.save_calibration(pj, jc)
    tyaml.save_calibration(pt, tc)
    with open(pj) as a, open(pt) as b:
        assert a.read() == b.read()
    from_j = tyaml.load_calibration(pj)
    from_t = jyaml.load_calibration(pt)
    for f in ("cam_k", "pro_k", "rot", "trans"):
        np.testing.assert_array_equal(getattr(from_j, f).numpy(),
                                      np.asarray(getattr(from_t, f)))


def _state_arrays(h, w):
    z = np.zeros((h, w), np.float32)
    return {"proj_u": z, "strip_w": z, "strip_b": z, "z": z, "frame_idx": 3}


def _default_device_calls(tmp_path):
    """The main path's library entry points that put data on a device,
    each called without one, and the same call on the CPU."""
    from slc_tpu_torch.checkpoint import load_state, save_state
    from slc_tpu_torch.dynamic import TrackerState
    calib = tcalib.synthetic_calibration(cam_h=24, cam_w=40, pro_h=96,
                                         pro_w=640)
    tables = {f: np.asarray(getattr(
        tcalib.build_tables(calib, 24, 40, device="cpu"), f))
        for f in _FIELDS}
    ckpt = save_state(str(tmp_path / "frame_3"), TrackerState.from_numpy(
        _state_arrays(24, 40), device="cpu"))
    return {
        "build_tables": lambda **kw: tcalib.build_tables(calib, 24, 40,
                                                         **kw).c,
        "TriangulationTables.from_numpy": lambda **kw:
            tcalib.TriangulationTables.from_numpy(tables, **kw).c,
        "TrackerState.from_numpy": lambda **kw: TrackerState.from_numpy(
            _state_arrays(24, 40), **kw).proj_u,
        "load_state": lambda **kw: load_state(ckpt, **kw).proj_u,
    }


@pytest.mark.parametrize("entry", ["build_tables",
                                   "TriangulationTables.from_numpy",
                                   "TrackerState.from_numpy", "load_state"])
def test_entry_points_default_to_the_card(tmp_path, entry):
    """Without a device these entry points go to the card: where there is
    none they raise instead of falling back to the CPU; ``device="cpu"``
    builds on the CPU."""
    call = _default_device_calls(tmp_path)[entry]
    assert call(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
