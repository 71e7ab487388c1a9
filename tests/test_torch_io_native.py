"""The port's native host I/O library (slc_tpu_torch/io/native) against
slc_tpu's on the same inputs: XYZ clouds byte for byte, BMP pixels and
bytes exactly, the threaded loader's ordering and fault records
(tests/test_native_loader.py and tests/test_bmp_edge.py on the port), the
two checks the port's copy of the codec adds, the build rule (concurrent
builders agree; a failed build raises), and the runner's XYZ stream
through the pool. Inputs are made from a seed with numpy."""

import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from slc_tpu import cloud as j_cloud
from slc_tpu.io.bmp import read_bmp as j_read_bmp
from slc_tpu.io.bmp import write_bmp as j_write_bmp

from slc_tpu_torch import cloud
from slc_tpu_torch.calib import synthetic_calibration
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.io import native
from slc_tpu_torch.io.bmp import _read_bmp_numpy, read_bmp, write_bmp
from slc_tpu_torch.io.dataset import (ReplayDataset, write_manifest,
                                      write_replay_dataset)
from slc_tpu_torch.io.opencv_yaml import save_calibration
from slc_tpu_torch.runner import run_replay
from slc_tpu_torch import synth

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BF = struct.Struct("<2sIHHI")
_BI = struct.Struct("<IiiHHIIiiII")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------------ XYZ


def _maps(kind, seed=0, shape=(48, 64)):
    """float32 x, y, z maps of one kind; z > 0 marks the points."""
    rng = np.random.default_rng(seed)
    x, y = rng.normal(0.0, 30.0, (2, *shape)).astype(np.float32)
    z = rng.uniform(40.0, 60.0, shape).astype(np.float32)
    if kind == "holes":
        z[rng.uniform(size=shape) < 0.3] = 0.0
        z[rng.uniform(size=shape) < 0.05] = -1.0
    elif kind == "negative":
        x = -np.abs(x) - rng.uniform(0, 1e-6, shape).astype(np.float32)
        y = rng.uniform(-1e-7, 0.0, shape).astype(np.float32)
    elif kind == "boundary":
        # Odd multiples of 1/256 end in a 5 at the 8th decimal: exact ties
        # at the 7th, which the native writer rounds up and np.savetxt to
        # even. The neighbours one float32 step away are no ties.
        tie = (rng.integers(0, 128, shape) * 2 + 1) / 256.0
        x = (np.floor(x) + tie).astype(np.float32)
        y = np.nextafter((np.floor(y) + tie).astype(np.float32),
                         np.float32(np.inf))
        z = (np.floor(z) + tie).astype(np.float32)
        z[::2] = np.nextafter(z[::2], np.float32(0))
    return x, y, z


@pytest.mark.parametrize("kind", ["random", "holes", "negative",
                                  "boundary"])
def test_write_xyz_bytes_match_slc_tpu(tmp_path, kind):
    """slc_tpu writes through its native formatter; the port's writer
    gives the same bytes, from numpy maps and from CPU tensors alike."""
    x, y, z = _maps(kind)
    want, got, got_t = (str(tmp_path / n) for n in ("j.txt", "t.txt",
                                                     "tt.txt"))
    n_j = j_cloud.write_xyz(want, x, y, z)
    before = native.COUNTS["xyz_writes"]
    assert cloud.write_xyz(got, x, y, z) == n_j == int((z > 0).sum())
    assert cloud.write_xyz(got_t, *(torch.from_numpy(a)
                                    for a in (x, y, z))) == n_j
    assert native.COUNTS["xyz_writes"] == before + 2
    assert _read(got) == _read(want)
    assert _read(got_t) == _read(want)
    if kind == "boundary":
        # The ties are what np.savetxt writes otherwise (the port's
        # writer before the native one).
        m = z > 0
        alt = str(tmp_path / "savetxt.txt")
        np.savetxt(alt, np.stack([x[m], y[m], z[m]], 1).astype(np.float64),
                   fmt="%.7f")
        assert _read(alt) != _read(want)


def test_write_xyz_mask_matches_slc_tpu(tmp_path):
    """With a mask both packages take np.savetxt."""
    x, y, z = _maps("holes", seed=1)
    mask = np.random.default_rng(2).uniform(size=z.shape) < 0.5
    want, got = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert cloud.write_xyz(got, x, y, z, mask) == \
        j_cloud.write_xyz(want, x, y, z, mask) == int(mask.sum())
    assert _read(got) == _read(want)


def test_write_xyz_unwritable_path_raises(tmp_path):
    x, y, z = _maps("random")
    path = str(tmp_path / "missing" / "c.txt")
    with pytest.raises(IOError, match="missing"):
        cloud.write_xyz(path, x, y, z)


# ------------------------------------------------------------------ BMP


def _bmp_bytes(rows, w, h, bpp, palette=b"", top_down=False):
    """A BMP file of ``rows`` (h, stride) bytes, stored top-down or
    bottom-up (rows[0] is the top row)."""
    stride = (w * bpp // 8 + 3) & ~3
    assert rows.shape == (h, stride)
    payload = (rows if top_down else rows[::-1]).tobytes()
    off = _BF.size + _BI.size + len(palette)
    return (_BF.pack(b"BM", off + len(payload), 0, 0, off)
            + _BI.pack(_BI.size, w, -h if top_down else h, 1, bpp, 0,
                       len(payload), 2835, 2835, len(palette) // 4, 0)
            + palette + payload)


def _palette(kind, rng, n=256):
    if kind == "identity":
        bgr = np.repeat(np.arange(n, dtype=np.uint8)[:, None], 3, 1)
    elif kind == "gray":                     # gray, but not the identity
        bgr = np.repeat((255 - np.arange(n)).astype(np.uint8)[:, None], 3,
                        1)
    else:
        bgr = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return np.concatenate([bgr, np.zeros((n, 1), np.uint8)], 1).tobytes()


_FORMATS = [(bpp, pal, top, w)
            for bpp, pal in ((8, "identity"), (8, "gray"), (8, "colour"),
                             (24, None), (32, None))
            for top in (False, True) for w in (37, 40)]


@pytest.mark.parametrize("bpp,pal,top_down,w", _FORMATS,
                         ids=[f"{b}bit-{p or 'bgr'}-"
                              f"{'topdown' if t else 'bottomup'}-w{w}"
                              for b, p, t, w in _FORMATS])
def test_read_bmp_matches_slc_tpu(tmp_path, bpp, pal, top_down, w):
    rng = np.random.default_rng(bpp + w + top_down)
    h = 23
    stride = (w * bpp // 8 + 3) & ~3
    rows = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    palette = _palette(pal, rng) if bpp == 8 else b""
    path = str(tmp_path / "f.bmp")
    with open(path, "wb") as f:
        f.write(_bmp_bytes(rows, w, h, bpp, palette, top_down))
    before = native.COUNTS["bmp_reads"]
    got = read_bmp(path)
    assert native.COUNTS["bmp_reads"] == before + 1    # the native codec
    assert got.dtype == np.uint8 and got.shape == (h, w)
    np.testing.assert_array_equal(got, j_read_bmp(path))
    np.testing.assert_array_equal(got, _read_bmp_numpy(path))
    if bpp != 8:
        np.testing.assert_array_equal(read_bmp(path, grayscale=False),
                                      j_read_bmp(path, grayscale=False))


@pytest.mark.parametrize("shape", [(23, 37), (16, 40), (1, 1)])
def test_write_bmp_bytes_match_slc_tpu(tmp_path, shape):
    rng = np.random.default_rng(shape[1])
    gray = rng.integers(0, 256, shape, dtype=np.uint8)
    rgb = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    for img in (gray, rgb):
        want, got = str(tmp_path / "j.bmp"), str(tmp_path / "t.bmp")
        j_write_bmp(want, img)
        write_bmp(got, img)
        assert _read(got) == _read(want)
        np.testing.assert_array_equal(read_bmp(got, grayscale=img.ndim == 2),
                                      img)


def test_long_palette_goes_to_the_numpy_codec(tmp_path):
    """colors_used > 256 overflowed slc_tpu's 256-entry palette buffer;
    the port's codec refuses the file and the numpy codec reads it."""
    rng = np.random.default_rng(5)
    h, w = 6, 8
    rows = rng.integers(0, 256, (h, w), dtype=np.uint8)
    palette = _palette("colour", rng, n=300)
    path = str(tmp_path / "long.bmp")
    with open(path, "wb") as f:
        f.write(_bmp_bytes(rows, w, h, 8, palette))
    assert native.read_gray(path) is None
    got = read_bmp(path)
    np.testing.assert_array_equal(got, _read_bmp_numpy(path))


def test_short_palette_index_past_it_goes_to_the_numpy_codec(tmp_path):
    """A pixel index past a short palette read an unset entry in
    slc_tpu's codec; the port's refuses the file, and the numpy codec's
    index raises, so read_bmp raises too. In range, the native codec
    reads a short palette as the numpy codec does."""
    rng = np.random.default_rng(6)
    h, w = 5, 8
    palette = _palette("colour", rng, n=16)
    rows = rng.integers(0, 16, (h, w), dtype=np.uint8)
    ok = str(tmp_path / "ok.bmp")
    with open(ok, "wb") as f:
        f.write(_bmp_bytes(rows, w, h, 8, palette))
    np.testing.assert_array_equal(native.read_gray(ok), _read_bmp_numpy(ok))
    rows[2, 3] = 200
    bad = str(tmp_path / "bad.bmp")
    with open(bad, "wb") as f:
        f.write(_bmp_bytes(rows, w, h, 8, palette))
    assert native.read_gray(bad) is None
    with pytest.raises(IndexError) as want:
        _read_bmp_numpy(bad)
    with pytest.raises(IndexError) as got:
        read_bmp(bad)
    assert str(got.value) == str(want.value)


def test_read_bmp_fuzz_garbage_never_crashes(tmp_path):
    """tests/test_bmp_edge.py:146-163 on the port's codec: random blobs
    (half with the BM magic) raise cleanly or give a sane image."""
    rng = np.random.default_rng(0)
    for k in range(40):
        blob = rng.integers(0, 256, rng.integers(0, 2048),
                            dtype=np.uint8).tobytes()
        if k % 2:
            blob = b"BM" + blob
        p = str(tmp_path / f"fuzz{k}.bin")
        with open(p, "wb") as f:
            f.write(blob)
        try:
            out = read_bmp(p)
        except (ValueError, IOError, OSError, struct.error):
            continue
        assert out.dtype == np.uint8 and out.ndim == 2


# --------------------------------------------------------------- loader


@pytest.fixture
def bmp_dir(tmp_path, rng):
    h, w = 24, 40
    imgs = [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(17)]
    paths = []
    for i, img in enumerate(imgs):
        p = str(tmp_path / f"frame{i}.bmp")
        write_bmp(p, img)
        paths.append(p)
    return paths, imgs, h, w


def test_loader_ordered_parity(bmp_dir):
    """More frames than ring slots, more threads than one: slot reuse and
    ordering across threads."""
    paths, imgs, h, w = bmp_dir
    before = native.COUNTS["loader_frames"]
    got = list(native.NativeFrameLoader(paths, h, w, slots=4, threads=3))
    assert len(got) == len(imgs)
    for g, want in zip(got, imgs):
        np.testing.assert_array_equal(g, want)
    assert native.COUNTS["loader_frames"] == before + len(imgs)


def test_loader_error_then_continue(bmp_dir, tmp_path):
    paths, imgs, h, w = bmp_dir
    bad = str(tmp_path / "bad.bmp")
    with open(bad, "wb") as f:
        f.write(b"not a bmp at all")
    loader = native.NativeFrameLoader([paths[0], bad, paths[2]], h, w,
                                      slots=2, threads=2)
    np.testing.assert_array_equal(next(loader), imgs[0])
    with pytest.raises(IOError, match="bad.bmp"):
        next(loader)
    np.testing.assert_array_equal(next(loader), imgs[2])
    with pytest.raises(StopIteration):
        next(loader)


def test_loader_shape_mismatch(bmp_dir):
    paths, _, h, w = bmp_dir
    loader = native.NativeFrameLoader(paths[:1], h + 1, w)
    with pytest.raises(IOError):
        next(loader)


def test_loader_early_close(bmp_dir):
    paths, _, h, w = bmp_dir
    loader = native.NativeFrameLoader(paths, h, w, slots=2, threads=2)
    next(loader)
    loader.close()            # joins the workers without deadlock
    loader.close()            # idempotent
    with pytest.raises(StopIteration):
        next(loader)


def _dataset(tmp_path, rng, n=9, h=16, w=32):
    frames = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    root = str(tmp_path / "ds")
    write_replay_dataset(root, rng.integers(0, 256, (4, h, w), np.uint8),
                         rng.integers(0, 256, (3, h, w), np.uint8),
                         frames=frames)
    return root, frames


def test_dataset_frames_native_path(tmp_path, rng):
    root, frames = _dataset(tmp_path, rng)
    ds = ReplayDataset(root)
    before = native.COUNTS["loader_frames"]
    np.testing.assert_array_equal(np.stack(list(ds.frames(native=True))),
                                  frames)
    assert native.COUNTS["loader_frames"] == before + len(frames)
    np.testing.assert_array_equal(np.stack(list(ds.frames(native=False))),
                                  frames)
    assert native.COUNTS["loader_frames"] == before + len(frames)
    np.testing.assert_array_equal(np.stack(list(ds.frames(start=5))),
                                  frames[5:])
    for native_ in (True, False):
        got = list(ds.indexed_frames(2, 7, native=native_))
        assert [i for i, _, _ in got] == list(range(2, 7))
        for i, frame, err in got:
            assert err is None
            np.testing.assert_array_equal(frame, frames[i])


def test_dataset_frames_skip_bad_frame(tmp_path, rng):
    """frames() skips an undecodable frame and goes on, on both paths;
    indexed_frames() reports it at its index."""
    root, frames = _dataset(tmp_path, rng, n=5)
    with open(os.path.join(root, "cFrame", "dynaCam2.bmp"), "wb") as f:
        f.write(b"corrupt, not a bmp")
    ds = ReplayDataset(root)
    want = np.stack([frames[i] for i in (0, 1, 3, 4)])
    for native_ in (True, False):
        np.testing.assert_array_equal(
            np.stack(list(ds.frames(native=native_))), want)
        got = list(ds.indexed_frames(native=native_))
        assert [i for i, _, _ in got] == [0, 1, 2, 3, 4]
        assert got[2][1] is None and got[2][2]


def test_indexed_frames_surfaces_midstream_bad_format(tmp_path):
    """tests/test_bmp_edge.py:79-109 on the port: an RLE8 frame mid-way
    (frame 0 probed fine) is a fault record at its index on both paths,
    and the stream goes on."""
    cdir = tmp_path / "ds" / "cFrame"
    cdir.mkdir(parents=True)
    h, w = 8, 8
    imgs = [np.full((h, w), 10 * i, np.uint8) for i in range(4)]
    for i, im in enumerate(imgs):
        write_bmp(str(cdir / f"dynaCam{i}.bmp"), im)
    pal = b"".join(struct.pack("<BBBB", i, i, i, 0) for i in range(256))
    off = _BF.size + _BI.size + len(pal)
    with open(cdir / "dynaCam2.bmp", "wb") as f:
        f.write(_BF.pack(b"BM", off + 2, 0, 0, off)
                + _BI.pack(_BI.size, w, h, 1, 8, 1, 2, 2835, 2835, 0, 0)
                + pal + b"\x08\x14")
    write_manifest(str(tmp_path / "ds"), {"frame_count": 4})
    ds = ReplayDataset(str(tmp_path / "ds"))
    for native_ in (True, False):
        got = list(ds.indexed_frames(native=native_))
        assert [i for i, _, _ in got] == [0, 1, 2, 3]
        for i, frame, err in got:
            if i == 2:
                assert frame is None and err
            else:
                assert err is None
                np.testing.assert_array_equal(frame, imgs[i])


def test_dataset_frames_python_path_on_shape_mismatch(tmp_path, rng):
    """A first frame whose size is not the manifest's: the Python reader
    delivers the frames as they are, instead of the pool failing them."""
    root = str(tmp_path / "ds")
    os.makedirs(os.path.join(root, "cFrame"))
    actual = rng.integers(0, 256, (8, 16), dtype=np.uint8)
    write_bmp(os.path.join(root, "cFrame", "dynaCam0.bmp"), actual)
    write_manifest(root, {"gray_count": 2, "phase_count": 2,
                          "frame_count": 1, "cam_h": 16, "cam_w": 32})
    ds = ReplayDataset(root)
    before = native.COUNTS["loader_frames"]
    got = list(ds.frames())
    assert len(got) == 1
    np.testing.assert_array_equal(got[0], actual)
    assert native.COUNTS["loader_frames"] == before


def test_abandoned_native_iteration_closes_the_pool(tmp_path, rng,
                                                   monkeypatch):
    """Leaving indexed_frames mid-stream closes the loader (its finally)."""
    root, _ = _dataset(tmp_path, rng, n=12)
    made = []

    class Recording(native.NativeFrameLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(native, "NativeFrameLoader", Recording)
    it = ReplayDataset(root).indexed_frames(native=True, prefetch=2)
    next(it)
    assert made and made[0]._handle is not None
    it.close()
    assert made[0]._handle is None


# ---------------------------------------------------------------- build


def test_concurrent_builds_agree(tmp_path):
    """Two processes that build into one empty directory at once both
    load the same library, and no temporary file is left."""
    build = str(tmp_path / "build")
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {_REPO!r})
        from slc_tpu_torch.io import native
        native._BUILD = {build!r}
        native.lib()
        print(native.library_path())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert os.listdir(build) == [os.path.basename(paths.pop())]


def test_failed_build_raises_with_stderr(tmp_path, monkeypatch):
    """A g++ that fails: the build raises with its stderr, and nothing
    falls back."""
    fake = tmp_path / "bin"
    fake.mkdir()
    gxx = fake / "g++"
    gxx.write_text("#!/bin/sh\necho 'fake g++: refusing to compile' >&2\n"
                   "exit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    for call in (native.lib, lambda: read_bmp(__file__)):
        with pytest.raises(RuntimeError, match="refusing to compile"):
            call()
    assert not os.listdir(tmp_path / "build")


# --------------------------------------------------------------- runner


def test_run_replay_xyz_streams_through_the_pool(tmp_path):
    """run_replay(out_format="xyz") on the CPU: one .txt per frame, each
    cloud by slc_write_xyz, every dynamic frame through the pool, and the
    frame-0 and tracker reads by the codec."""
    cfg = SystemConfig(cam_h=96, cam_w=160, pro_h=96, pro_w=640,
                       gray_bits=5)
    n = 8
    calib = synthetic_calibration(cam_h=96, cam_w=160, pro_h=96, pro_w=640)
    scene = synth.render_static_scene(calib, cfg, synth.plane_surface(50.0),
                                      noise_sigma=1.0)
    frames, _, _ = synth.render_dynamic_sequence(
        calib, cfg, n, z0=50.0, dz_per_frame=0.3, stripe_period=12,
        noise_sigma=1.0)
    root = str(tmp_path / "ds")
    write_replay_dataset(root, scene.gray_images, scene.phase_images,
                         frames, config_fields={"stripe_period": 12})
    save_calibration(os.path.join(root, "parameters.yml"), calib)
    out = str(tmp_path / "o")
    native.reset_counts()
    rep = run_replay(root, os.path.join(root, "parameters.yml"), out, cfg,
                     device="cpu", out_format="xyz")
    counts = dict(native.COUNTS)
    assert rep.frames_done == n - 1
    txt = sorted(f for f in os.listdir(out) if f.endswith(".txt"))
    assert txt == sorted(["iFrame.txt"] + [f"cFrame{i}.txt"
                                           for i in range(1, n)])
    # Frame 0's 10 gray + 4 phase planes, the period diagnostic's frame
    # 0, the tracker's frame 0 and the warm-up step's frame 1.
    assert counts == {"loader_frames": n - 1,
                      "bmp_reads": 2 * cfg.gray_bits + cfg.phase_steps + 3,
                      "bmp_writes": 0, "xyz_writes": n}
    pts = np.loadtxt(os.path.join(out, f"cFrame{n - 1}.txt"))
    assert pts.shape[1] == 3 and (np.abs(pts[:, 2] - 52.1) < 1.0).mean() > 0.99
