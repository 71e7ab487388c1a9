"""Point clouds, normals, preview renders, their writers and the
visualization helpers: slc_tpu_torch.cloud and .visualization on the CPU
against slc_tpu's on the same inputs (tests/test_cloud_io.py:21-117 and
:183-254 are the behaviours mirrored).

Bars: depth_to_cloud rtol 1e-6; cloud_normals valid masks identical,
normals within 1e-5; luminance_map and render_depth_map u8 |diff| <= 1 on
at most 0.1% of the pixels (render_depth_map against slc_tpu's chain with
its Pallas bilateral kernel in interpret mode: the border semantics the
port's filter follows); writers and visualization byte or value
identical.
"""

import filecmp
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slc_tpu import cloud as jcloud
from slc_tpu import visualization as jvis
from slc_tpu.pallas.bilateral import bilateral_filter_pallas

from slc_tpu_torch import cloud, visualization as vis
from slc_tpu_torch.io.bmp import read_bmp

torch.set_num_threads(2)

K = (200.0, 190.0, 31.5, 23.25)      # fx, fy, cx, cy


def _t(a):
    return torch.tensor(np.asarray(a))


def _surface(h=48, w=64, holes=0.05, seed=0):
    """A bumpy, tilted depth map around 40 with a fraction of holes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    z = (40.0 + 0.05 * xx - 0.03 * yy + 0.8 * np.sin(xx / 5.0)
         * np.cos(yy / 7.0) + rng.normal(0, 0.01, (h, w)))
    z[rng.uniform(size=(h, w)) < holes] = 0.0
    return z.astype(np.float32)


def _u8_close(got, want, frac=1e-3):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


# ------------------------------------------------------------------ cloud

def test_depth_to_cloud_pinhole():
    z0, fx, fy, cx, cy = 50.0, 600.0, 600.0, 32.0, 24.0
    c = cloud.depth_to_cloud(torch.full((48, 64), z0), fx, fy, cx, cy)
    assert c.shape == (48, 64, 3) and c.dtype == torch.float32
    assert torch.allclose(c[..., 2], torch.tensor(z0))
    assert torch.allclose(c[24, 32], torch.tensor([0.0, 0.0, z0]))
    assert float(c[24, 33, 0]) == pytest.approx(z0 / fx)


@pytest.mark.parametrize("flip_xz", [False, True])
def test_depth_to_cloud_matches_slc_tpu(flip_xz):
    z = _surface()
    got = cloud.depth_to_cloud(_t(z), *K, flip_xz=flip_xz).numpy()
    want = np.asarray(jcloud.depth_to_cloud(jnp.asarray(z), *K,
                                            flip_xz=flip_xz))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if flip_xz:
        # depthMapUtils.cpp:32-34: z' = -z, x' = -(j - cx) z' / fx.
        assert np.allclose(got[..., 2], -z)
        assert np.allclose(got[4, 5, 0], -(5 - K[2]) * -z[4, 5] / K[0])


def test_depth_to_cloud_batches_over_leading_axes():
    z = np.stack([_surface(seed=1), _surface(seed=2)])
    got = cloud.depth_to_cloud(_t(z), *K)
    for i in range(2):
        assert torch.equal(got[i], cloud.depth_to_cloud(_t(z[i]), *K))


def test_cloud_normals_plane():
    """A z = const plane has normal -z with the right/down cross product
    (depthMapUtils.cpp:116: (down-c) x (right-c))."""
    depth = torch.full((16, 16), 30.0)
    c = cloud.depth_to_cloud(depth, 200.0, 200.0, 8.0, 8.0)
    n, ok = cloud.cloud_normals(c, depth > 0)
    assert ok[:15, :15].all() and not ok[15].any() and not ok[:, 15].any()
    assert torch.allclose(n[ok], torch.tensor([0.0, 0.0, -1.0]), atol=1e-5)


def test_cloud_normals_invalid_propagation():
    depth = torch.full((8, 8), 30.0)
    depth[3, 4] = 0.0
    c = cloud.depth_to_cloud(depth, 100.0, 100.0, 4.0, 4.0)
    _, ok = cloud.cloud_normals(c, depth > 0)
    # Itself plus the pixels whose right/down neighbour it is.
    assert not ok[3, 4] and not ok[3, 3] and not ok[2, 4]
    assert ok[3, 5] and ok[4, 4]


def test_cloud_normals_match_slc_tpu():
    z = _surface(holes=0.1)
    c = jcloud.depth_to_cloud(jnp.asarray(z), *K)
    want_n, want_ok = map(np.asarray, jcloud.cloud_normals(
        c, jnp.asarray(z) > 0))
    got_n, got_ok = cloud.cloud_normals(_t(np.asarray(c)), _t(z) > 0)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    np.testing.assert_allclose(got_n.numpy(), want_n, rtol=0, atol=1e-5)


def test_luminance_map_range_and_holes():
    depth = torch.full((32, 32), 40.0)
    depth[:4] = 0.0
    c = cloud.depth_to_cloud(depth, 200.0, 200.0, 16.0, 16.0)
    n, ok = cloud.cloud_normals(c, depth > 0)
    lum = cloud.luminance_map(c, n, ok)
    assert lum.dtype == torch.uint8
    assert (lum[:4] == 0).all()
    # ambient 60 is the floor for any lit pixel (depthMapUtils.cpp:131).
    assert (lum[ok] >= 60).all()


def test_luminance_map_matches_slc_tpu():
    z = _surface(96, 128, holes=0.05, seed=3)
    c = jcloud.depth_to_cloud(jnp.asarray(z), *K)
    n, ok = jcloud.cloud_normals(c, jnp.asarray(z) > 0)
    want = np.asarray(jcloud.luminance_map(c, n, ok))
    got = cloud.luminance_map(*(_t(np.asarray(a)) for a in (c, n, ok)))
    assert got.dtype == torch.uint8
    _u8_close(got.numpy(), want)


def test_luminance_u8_cast_truncates():
    """The clip then the cast truncate, as astype(uint8) does: a lit
    pixel facing the light head-on gets int(60 + 150 + 50 * s^0.2)."""
    c = torch.tensor([[[0.0, 0.0, 10.0]]])
    n = torch.tensor([[[0.0, 0.0, -1.0]]])
    lum = cloud.luminance_map(c, n, torch.tensor([[True]]))
    want = jcloud.luminance_map(jnp.asarray(c.numpy()), jnp.asarray(n.numpy()),
                                jnp.asarray([[True]]))
    assert int(lum[0, 0]) == int(np.asarray(want)[0, 0])
    view = np.array([1.0, 1.0, -9.0]) / np.linalg.norm([1.0, 1.0, -9.0])
    s = float(view @ np.array([0.0, 0.0, -1.0]))
    assert int(lum[0, 0]) == int(min(60 + 150 + 50 * s ** 0.2, 255.0))


def test_render_depth_map_runs():
    lum = cloud.render_depth_map(torch.full((32, 32), 40.0), 200.0, 200.0,
                                 16.0, 16.0)
    assert lum.shape == (32, 32) and lum.dtype == torch.uint8
    assert (lum[:31, :31] >= 60).all()


def _jax_render_pallas(z):
    """slc_tpu's render chain (cloud.py:167-187) with its Pallas
    bilateral kernel in interpret mode in place of the XLA filter."""
    zj = jnp.asarray(z)
    filtered = bilateral_filter_pallas(zj, 1, 10.0, 25.0, interpret=True)
    normals, ok = jcloud.cloud_normals(jcloud.depth_to_cloud(filtered, *K),
                                       filtered > 0)
    return np.asarray(jcloud.luminance_map(jcloud.depth_to_cloud(zj, *K),
                                           normals, ok))


@pytest.mark.parametrize("shape", [(61, 130), (96, 128)])
def test_render_depth_map_matches_slc_tpu(shape):
    """The whole render against slc_tpu's chain with its Pallas filter,
    and against its XLA render on the interior. The filters differ in
    their last bits (slc_tpu's fuse multiply-adds and take exp2), which
    the specular term (s^0.2, steep where s is small) turns into +-1
    steps; on 256x320 of this surface 0.11% of the pixels step, some by
    2. Given slc_tpu's filtered depth, the port's normals and shading
    give its u8 exactly."""
    z = _surface(*shape, holes=0.05, seed=4)
    got = cloud.render_depth_map(_t(z), *K)
    _u8_close(got.numpy(), _jax_render_pallas(z))
    want = np.asarray(jcloud.render_depth_map(jnp.asarray(z), *K))
    _u8_close(got.numpy()[1:-2, 1:-2], want[1:-2, 1:-2])

    filtered = bilateral_filter_pallas(jnp.asarray(z), 1, 10.0, 25.0,
                                       interpret=True)
    n, ok = jcloud.cloud_normals(jcloud.depth_to_cloud(filtered, *K),
                                 filtered > 0)
    want = jcloud.luminance_map(jcloud.depth_to_cloud(jnp.asarray(z), *K),
                                n, ok)
    f = _t(np.asarray(filtered))
    n, ok = cloud.cloud_normals(cloud.depth_to_cloud(f, *K), f > 0)
    got = cloud.luminance_map(cloud.depth_to_cloud(_t(z), *K), n, ok)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_normalize_no_static_cache():
    """The reference's static min/max bug (depthMapUtils.cpp:198-199) is
    not reproduced: each call uses its own range."""
    a = np.linspace(0, 100, 64, dtype=np.float32).reshape(8, 8)
    b = np.linspace(0, 1000, 64, dtype=np.float32).reshape(8, 8)
    for x in (a, b):
        got = cloud.normalize_to_u8(_t(x))
        assert got.dtype == torch.uint8
        assert int(got.max()) == 255 and int(got.min()) == 0
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jcloud.normalize_to_u8(jnp.asarray(x))))


# ---------------------------------------------------------------- writers

def test_write_xyz_with_mask_matches_slc_tpu(tmp_path):
    rng = np.random.default_rng(0)
    x, y, z = (rng.normal(0, 10, (6, 7)).astype(np.float32)
               for _ in range(3))
    mask = rng.uniform(size=(6, 7)) > 0.3
    p, q = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    n = cloud.write_xyz(p, _t(x), _t(y), _t(z), mask=mask)
    assert n == jcloud.write_xyz(q, x, y, z, mask=mask) == int(mask.sum())
    assert filecmp.cmp(p, q, shallow=False)


def test_write_xyz_normals_and_rgb_match_slc_tpu(tmp_path):
    c = np.random.default_rng(0).normal(size=(4, 4, 3))
    n = np.zeros((4, 4, 3))
    n[..., 2] = 1.0
    valid = np.ones((4, 4), bool)
    valid[0] = False
    p1, q1 = str(tmp_path / "n.txt"), str(tmp_path / "jn.txt")
    assert cloud.write_xyz_normals(p1, _t(c), _t(n), _t(valid)) == 12
    jcloud.write_xyz_normals(q1, c, n, valid)
    assert filecmp.cmp(p1, q1, shallow=False)
    assert np.loadtxt(p1).shape == (12, 6)
    gray_img = np.full((4, 4), 128, np.uint8)
    for color in (gray_img, None, np.arange(48, dtype=np.uint8)
                  .reshape(4, 4, 3)):
        p2, q2 = str(tmp_path / "rgb.txt"), str(tmp_path / "jrgb.txt")
        assert cloud.write_xyz_rgb(p2, c, valid, color) == 12
        jcloud.write_xyz_rgb(q2, c, valid, color)
        assert filecmp.cmp(p2, q2, shallow=False)
    data = np.loadtxt(str(tmp_path / "rgb.txt"))
    assert data.shape == (12, 6)


# ---------------------------------------------------------- visualization

def test_visualization_show_gated(tmp_path, monkeypatch):
    img = np.linspace(0, 1, 64).reshape(8, 8)
    monkeypatch.setattr(vis, "VISUAL_DEBUG", False)
    assert vis.show("x", img, out_dir=str(tmp_path)) is None
    p = vis.show("x", img, out_dir=str(tmp_path), force=True)
    assert p and os.path.exists(p)
    q = jvis.show("x", img, out_dir=str(tmp_path / "j"), force=True)
    assert filecmp.cmp(p, q, shallow=False)
    disp = read_bmp(p)
    assert disp.min() == 0 and disp.max() == 255


def test_store_images_batch(tmp_path):
    rng = np.random.default_rng(1234)
    imgs = [rng.integers(0, 256, (16, 16), dtype=np.uint8)
            for _ in range(3)] + [rng.normal(size=(16, 16))]
    d = str(tmp_path / "arch" / "nested")
    assert vis.store_images(imgs, d, "img", start_idx=5) == 4
    jvis.store_images(imgs, str(tmp_path / "j"), "img", start_idx=5)
    for i in (5, 6, 7, 8):
        name = f"img{i}.bmp"
        assert filecmp.cmp(os.path.join(d, name),
                           os.path.join(tmp_path, "j", name), shallow=False)
    for i in (5, 6, 7):
        np.testing.assert_array_equal(
            read_bmp(os.path.join(d, f"img{i}.bmp")), imgs[i - 5])
    with pytest.raises(ValueError):
        vis.store_images(imgs, d, "img", suffix=".png")


@pytest.mark.parametrize("zoom", [1.0, 2.0, 0.5, 2.9999999])
def test_resize_bilinear_matches_slc_tpu(zoom):
    img = np.arange(64, dtype=np.float64).reshape(8, 8)
    for a in (img, img.astype(np.uint8), np.stack([img] * 3, -1)):
        got = vis.resize_bilinear(a, zoom)
        want = jvis.resize_bilinear(a, zoom)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    up = vis.resize_bilinear(img, 2.0)
    np.testing.assert_allclose(np.diff(up[2:-2, 2:-2], axis=1), 0.5,
                               atol=1e-12)


def test_normalize_depth_u16_exact():
    d = np.array([[100, 200], [300, 400]], np.uint16)
    want = ((d.astype(np.float64) - 100) / 300.0 * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(vis.normalize_depth_u16(d), want)
    np.testing.assert_array_equal(vis.normalize_depth_u16(d + 1000), want)
    np.testing.assert_array_equal(
        vis.normalize_depth_u16(np.full((2, 2), 7, np.uint16)),
        np.zeros((2, 2), np.uint8))


def test_normalize_f64_max_scale_quirk():
    d = np.array([[0.0, 1.0], [50.0, 100.0]])
    got = vis.normalize_f64(d)
    np.testing.assert_array_equal(got, jvis.normalize_f64(d))
    assert got[0, 0] == 0 and got[0, 1] == 255
    assert got[1, 0] == 255 and got[1, 1] == 255


def test_show_zoom(tmp_path):
    img = np.linspace(0, 255, 64).reshape(8, 8)
    p = vis.show("zoomed", img, out_dir=str(tmp_path), zoom=2.0, force=True)
    assert read_bmp(p).shape == (16, 16)
