"""slc_tpu_torch.streaming and the runner's chunk path on the CPU, against
the port's own per-frame loop (exactly: the same steps on the same
inputs) and against slc_tpu.streaming / slc_tpu.runner on the same
seeded inputs (the port's versions of tests/test_streaming.py and of
tests/test_runner.py:434-487). Bars against slc_tpu: P 2e-3, z, x and y
4e-3 (the locked step's, ROADMAP North star)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slc_tpu import calib as jcalib
from slc_tpu import streaming as jstream
from slc_tpu import synth as jsynth
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.dynamic import init_tracker as j_init
from slc_tpu.io.dataset import write_anchor_group, write_replay_dataset
from slc_tpu.io.opencv_yaml import save_calibration
from slc_tpu.runner import run_replay as j_run

from slc_tpu_torch import calib as tcalib
from slc_tpu_torch import streaming
from slc_tpu_torch.config import SystemConfig
from slc_tpu_torch.dynamic import dynamic_step, init_tracker
from slc_tpu_torch.runner import run_replay

torch.set_num_threads(2)

_SHAPE = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5)
JCFG = JConfig(**_SHAPE)
CFG = SystemConfig(**_SHAPE)
BAR_P, BAR_Z = 2e-3, 4e-3


@pytest.fixture(scope="module")
def rig():
    jc = jcalib.synthetic_calibration(cam_h=96, cam_w=160, pro_h=96,
                                      pro_w=640)
    tc = tcalib.synthetic_calibration(cam_h=96, cam_w=160, pro_h=96,
                                      pro_w=640)
    return (jcalib.build_tables(jc, 96, 160),
            tcalib.build_tables(tc, 96, 160, device="cpu"), jc)


def _sequence(rig, n, dz=0.4):
    """n rendered frames and the two packages' start states (functions:
    slc_tpu's step donates its state)."""
    frames, zs, pus = jsynth.render_dynamic_sequence(
        rig[2], JCFG, n, z0=50.0, dz_per_frame=dz, stripe_period=12)

    def jstate(subpixel=True):
        return j_init(jnp.asarray(frames[0]),
                      jnp.asarray(pus[0], jnp.float32),
                      jnp.asarray(zs[0], jnp.float32), JCFG,
                      subpixel=subpixel)

    def tstate(subpixel=True):
        return init_tracker(torch.from_numpy(frames[0]),
                            torch.from_numpy(pus[0].astype(np.float32)),
                            torch.from_numpy(zs[0].astype(np.float32)), CFG,
                            subpixel)
    return frames, jstate, tstate


def _per_frame(state, frames, tables, **kw):
    out = []
    for f in frames:
        state, res = dynamic_step(state, torch.from_numpy(f), tables, CFG,
                                  **kw)
        out.append(res)
    return state, out


def test_streaming_matches_synchronous_and_jax(rig):
    jt, tt, _ = rig
    frames, jstate, tstate = _sequence(rig, 5)
    _, ref = _per_frame(tstate(), frames[1:], tt)
    got = list(streaming.stream_frames(tstate(), frames[1:], tt, CFG))
    # slc_tpu donates each yielded state to the next step: read it first.
    want = [(np.asarray(jst.proj_u),
             [np.asarray(getattr(jr, k)) for k in ("z", "x", "y")])
            for jst, jr in jstream.stream_frames(jstate(), frames[1:], jt,
                                                 JCFG)]
    assert len(got) == len(want) == 4
    for (st, r), res, (j_pu, j_zxy) in zip(got, ref, want):
        np.testing.assert_array_equal(r.z.numpy(), res.z.numpy())
        np.testing.assert_array_equal(st.proj_u.numpy(),
                                      res.proj_u.numpy())
        np.testing.assert_allclose(st.proj_u.numpy(), j_pu, atol=BAR_P)
        for k, want_k in zip(("z", "x", "y"), j_zxy):
            np.testing.assert_allclose(getattr(r, k).numpy(), want_k,
                                       atol=BAR_Z)


def test_chunked_stream_matches_per_frame_and_jax(rig):
    """stream_chunks reproduces the per-frame loop exactly, with a ragged
    tail chunk and with device-tensor input, and slc_tpu's chunks within
    the bars; every yielded state keeps its values as the iteration
    advances (the port's rule in place of donation)."""
    jt, tt, _ = rig
    frames, jstate, tstate = _sequence(rig, 9)
    st_ref, ref = _per_frame(tstate(), frames[1:], tt)

    got_z, states, kept = [], [], []
    for st, z_stack in streaming.stream_chunks(tstate(), list(frames[1:]),
                                               tt, CFG, chunk=3):
        got_z.extend(z_stack)
        states.append(st)
        kept.append(st.proj_u.clone())
    assert [len(s) for s in (got_z, states)] == [8, 4]    # 3 + 3 + 1 + 1
    for a, r in zip(got_z, ref):
        np.testing.assert_array_equal(a.numpy(), r.z.numpy())
    np.testing.assert_array_equal(states[-1].proj_u.numpy(),
                                  st_ref.proj_u.numpy())
    for st, pu in zip(states, kept):
        assert torch.equal(st.proj_u, pu)
    assert len({st.proj_u.data_ptr() for st in states}) == len(states)

    want = [np.asarray(z) for _, zs in jstream.stream_chunks(
        jstate(), list(frames[1:]), jt, JCFG, chunk=3) for z in zs]
    for a, b in zip(got_z, want):
        np.testing.assert_allclose(a.numpy(), b, atol=BAR_Z)

    dev = [torch.from_numpy(f) for f in frames[1:]]
    got2 = [z for _, zs in streaming.stream_chunks(tstate(), dev, tt, CFG,
                                                    chunk=4) for z in zs]
    for a, r in zip(got2, ref):
        np.testing.assert_array_equal(a.numpy(), r.z.numpy())


@pytest.mark.parametrize("lock", [None, 12.0])
def test_chunk_step_xyz_matches_per_frame_and_jax(rig, lock):
    jt, tt, _ = rig
    frames, jstate, tstate = _sequence(rig, 6, dz=0.1)
    kw = dict(phase_lock=lock, lock_win_u=21, lock_win_v=9)
    st_ref, ref = _per_frame(tstate(), frames[1:], tt, **kw)
    st, (zs, xs, ys) = streaming.chunk_step_xyz(
        tstate(), torch.from_numpy(frames[1:]), tt, CFG, **kw)
    assert zs.shape == (5, 96, 160) and st.frame_idx == 5
    for k, stack in (("z", zs), ("x", xs), ("y", ys)):
        np.testing.assert_array_equal(
            stack.numpy(), torch.stack([getattr(r, k) for r in ref]).numpy())
    for k in ("proj_u", "strip_w", "strip_b", "z"):
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      getattr(st_ref, k).numpy())
    jst, jmaps = jstream.chunk_step_xyz(jstate(), jnp.asarray(frames[1:]),
                                        jt, JCFG, **kw)
    np.testing.assert_allclose(st.proj_u.numpy(), np.asarray(jst.proj_u),
                               atol=BAR_P)
    for a, b in zip((zs, xs, ys), jmaps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BAR_Z)


def test_run_streaming_chunked_stats(rig):
    _, tt, _ = rig
    frames, _, tstate = _sequence(rig, 7)
    fetched = []
    _, stats = streaming.run_streaming(
        tstate(), frames[1:], tt, CFG, chunk=3,
        fetch_z=lambda z: fetched.append(tuple(z.shape)))
    s = stats.summary()
    assert s["frames"] == 6 and s["fps"] > 0
    assert fetched == [(3, 96, 160), (3, 96, 160)]


def test_run_streaming_stats(rig):
    _, tt, _ = rig
    frames, _, tstate = _sequence(rig, 4)
    _, stats = streaming.run_streaming(tstate(), frames[1:], tt, CFG)
    s = stats.summary()
    assert s["frames"] == 3 and s["fps"] > 0
    assert set(s) == {"frames", "fps", "p50_ms", "p95_ms"}


def test_measure_overlap_reports_consistent_timings(rig):
    _, tt, _ = rig
    frames, _, tstate = _sequence(rig, 5, dz=0.1)
    state = tstate()
    before = state.proj_u.clone()
    ov = streaming.measure_overlap(state, frames[1:], tt, CFG)
    for k in ("compute_ms", "transfer_ms", "pipelined_ms",
              "sequential_ms", "overlap_efficiency",
              "speedup_vs_sequential"):
        assert k in ov, k
    assert ov["frames"] == 4
    assert 0.0 <= ov["overlap_efficiency"] <= 1.0
    assert ov["pipelined_ms"] > 0 and ov["sequential_ms"] > 0
    assert torch.equal(state.proj_u, before)


def test_streaming_robust_flag_passthrough(rig):
    """robust=False reaches the step through both streaming paths."""
    _, tt, _ = rig
    frames, _, tstate = _sequence(rig, 5)
    _, ref_t = _per_frame(tstate(), frames[1:], tt)
    _, ref_f = _per_frame(tstate(), frames[1:], tt, robust=False)
    assert any(not torch.equal(a.z, b.z) for a, b in zip(ref_t, ref_f)), \
        "robust flag must change results on this scene"
    got = [r.z for _, r in streaming.stream_frames(
        tstate(), frames[1:], tt, CFG, robust=False)]
    got2 = [z for _, zs in streaming.stream_chunks(
        tstate(), list(frames[1:]), tt, CFG, chunk=2, robust=False)
        for z in zs]
    for a, b, r in zip(got, got2, ref_f):
        assert torch.equal(a, r.z) and torch.equal(b, r.z)


@pytest.mark.parametrize("kw", [dict(fetch=lambda r: r),
                                dict(sync_every=2)])
def test_run_streaming_chunk_rejects_per_frame_args(rig, kw):
    _, tt, _ = rig
    frames, _, tstate = _sequence(rig, 4)
    with pytest.raises(ValueError, match="chunk"):
        streaming.run_streaming(tstate(), frames[1:], tt, CFG, chunk=2,
                                **kw)


def test_run_streaming_ragged_chunk_latencies(rig):
    """7 frames in chunks of 3: sizes 3, 3, 1, each latency recorded."""
    _, tt, _ = rig
    frames, _, tstate = _sequence(rig, 8)
    _, stats = streaming.run_streaming(tstate(), frames[1:], tt, CFG,
                                       chunk=3)
    assert stats.chunk_sizes == [3, 3, 1]
    assert len(stats.chunk_latencies_s) == 3
    assert len(stats.latencies_s) == 7
    for dt, k in zip(stats.chunk_latencies_s, stats.chunk_sizes):
        assert dt > 0 and k >= 1


def test_measure_overlap_compute_repeats(rig):
    _, tt, _ = rig
    frames, _, tstate = _sequence(rig, 5)
    ov = streaming.measure_overlap(tstate(), frames[1:], tt, CFG,
                                   compute_repeats=3)
    assert ov["compute_repeats"] == 3
    assert ov["regime"] in ("balanced", "transfer_bound", "compute_bound")
    assert 0.0 < ov["leg_ratio"] <= 1.0
    ov_auto = streaming.measure_overlap(tstate(), frames[1:], tt, CFG,
                                        compute_repeats="auto")
    assert ov_auto["compute_repeats"] >= 1


def test_stager_on_the_cpu_and_ring_size():
    frames = [np.full((4, 6), i, np.uint8) for i in range(3)]
    stager = streaming.HostStager("cpu")
    one = stager.put(frames[1]).wait()
    stack = stager.put(frames).wait()
    assert one.dtype == torch.uint8 and int(one[0, 0]) == 1
    assert stack.shape == (3, 4, 6) and stack[:, 0, 0].tolist() == [0, 1, 2]
    out = torch.zeros((3, 4, 6), dtype=torch.uint8)
    got = stager.put(frames[2], out=out[1]).wait()
    assert got.data_ptr() == out[1].data_ptr()
    assert out[:, 0, 0].tolist() == [0, 2, 0]
    with pytest.raises(ValueError, match="does not take"):
        stager.put(frames[2], out=out)
    with pytest.raises(ValueError, match="at least 2"):
        streaming.HostStager("cpu", slots=1)


# --- the runner's chunk path ----------------------------------------------

@pytest.fixture(scope="module")
def anchored_dataset(tmp_path_factory):
    """tests/test_runner.py:434-452's dataset: 11 frames moving 0.3 a
    frame, an anchor group at frame 5."""
    root = str(tmp_path_factory.mktemp("chunk") / "ds")
    calib = jcalib.synthetic_calibration(cam_h=96, cam_w=160, pro_h=96,
                                         pro_w=640)
    scene = jsynth.render_static_scene(calib, JCFG,
                                       jsynth.plane_surface(50.0),
                                       noise_sigma=1.0)
    frames, _, _ = jsynth.render_dynamic_sequence(
        calib, JCFG, 11, z0=50.0, dz_per_frame=0.3, stripe_period=12,
        noise_sigma=1.0)
    write_replay_dataset(root, scene.gray_images, scene.phase_images, frames)
    asc = jsynth.render_static_scene(calib, JCFG,
                                     jsynth.plane_surface(50.0 + 5 * 0.3),
                                     noise_sigma=1.0, seed=5)
    write_anchor_group(root, 5, asc.gray_images, asc.phase_images)
    save_calibration(os.path.join(root, "parameters.yml"), calib)
    return root


def _clouds(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".npz"))


def test_chunked_run_matches_per_frame_and_jax(anchored_dataset, tmp_path):
    """run_replay(chunk=4) with injected faults and an anchor at frame 5:
    the same records, faults, re-anchors and clouds as the port's
    per-frame run, exactly; z within 4e-3 of slc_tpu's chunked run."""
    root = anchored_dataset
    calib = os.path.join(root, "parameters.yml")
    kw = dict(fault_drop_prob=0.25, fault_seed=11, out_format="npz")
    reps = {name: run_replay(root, calib, str(tmp_path / name), CFG,
                             device="cpu", chunk=k, **kw)
            for name, k in (("per_frame", 1), ("chunked", 4))}
    j_run(root, calib, str(tmp_path / "jax"), JCFG, chunk=4, **kw)
    a = reps["per_frame"].metrics.records
    b = reps["chunked"].metrics.records
    assert reps["chunked"].frames_done == reps["per_frame"].frames_done
    assert [r["frame"] for r in a] == [r["frame"] for r in b]
    assert ([r["frame"] for r in a if "fault" in r]
            == [r["frame"] for r in b if "fault" in r])
    assert [r["frame"] for r in b if "fault" in r], "no fault injected"
    assert ([r["frame"] for r in a if r.get("reanchor")]
            == [r["frame"] for r in b if r.get("reanchor")])
    for ra, rb in zip(a, b):
        for k in ("valid_frac", "z_min", "z_max", "z_mean"):
            assert ra[k] == rb[k], (ra["frame"], k)
    assert any("t_dynamic_chunk_ms" in r and "gbps_dynamic_chunk" in r
               for r in b)
    files = _clouds(tmp_path / "per_frame")
    assert files == _clouds(tmp_path / "chunked") == _clouds(tmp_path / "jax")
    assert len(files) >= 5
    for f in files:
        pa = np.load(tmp_path / "per_frame" / f)
        pb = np.load(tmp_path / "chunked" / f)
        pj = np.load(tmp_path / "jax" / f)
        for k in ("x", "y", "z"):
            np.testing.assert_array_equal(pa[k], pb[k])
            np.testing.assert_allclose(pb[k], pj[k], atol=BAR_Z)


def test_chunked_checkpoint_resume_matches_uninterrupted(anchored_dataset,
                                                         tmp_path):
    """Checkpoints land on chunk boundaries (frame_{last of the chunk},
    written when a frame of it is a multiple of checkpoint_every); a
    resume from them lands on the uninterrupted run's terminal state."""
    root = anchored_dataset
    calib = os.path.join(root, "parameters.yml")
    kw = dict(device="cpu", chunk=3, use_anchors=False, out_format="npz")
    full = run_replay(root, calib, str(tmp_path / "full"), CFG, **kw)
    out = str(tmp_path / "resumed")
    run_replay(root, calib, out, CFG, checkpoint_every=2, max_frames=6,
               **kw)
    # Frames 1-3 run as a chunk (2 in it), then 4-5 frame by frame at the
    # end of the sequence (4 in them).
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "frame_3.npz", "frame_5.npz"]
    resumed = run_replay(root, calib, out, CFG, checkpoint_every=2,
                         resume=True, **kw)
    assert resumed.metrics.records[1]["frame"] == 6
    assert resumed.frames_done == full.frames_done == 10
    a, b = full.metrics.records[-1], resumed.metrics.records[-1]
    for k in ("frame", "valid_frac", "z_mean"):
        assert a[k] == b[k]
    np.testing.assert_array_equal(
        np.load(tmp_path / "full" / "cFrame10.npz")["z"],
        np.load(os.path.join(out, "cFrame10.npz"))["z"])


def test_chunk_must_be_positive(anchored_dataset, tmp_path):
    with pytest.raises(ValueError, match="chunk"):
        run_replay(anchored_dataset,
                   os.path.join(anchored_dataset, "parameters.yml"),
                   str(tmp_path / "o"), CFG, device="cpu", chunk=0)


def test_staging_copy_checks_the_frame():
    """The stager takes any layout of a frame (staged C-contiguous), stacks
    only frames of one shape and type, and refuses an ``out`` of another
    shape."""
    a = np.arange(24, dtype=np.uint8).reshape(4, 6)
    parts, shape, dtype = streaming._host_parts(np.asfortranarray(a))
    assert shape == (4, 6) and dtype == torch.uint8
    assert parts[0].flags.c_contiguous
    np.testing.assert_array_equal(parts[0], a)
    stager = streaming.HostStager("cpu")
    np.testing.assert_array_equal(
        stager.put(np.asfortranarray(a)).wait().numpy(), a)
    for bad in (a.astype(np.int16), a[:, :5]):
        with pytest.raises(ValueError, match="does not stack"):
            stager.put([a, bad])
    with pytest.raises(ValueError, match="no frame"):
        stager.put([])
    with pytest.raises(ValueError, match="does not take"):
        stager.put(a[:, :5], out=torch.zeros((4, 6), dtype=torch.uint8))


def test_stager_on_the_cpu_copies_the_frame():
    """On the CPU a staged frame is a copy: changing the numpy frame after
    ``put`` changes nothing staged, and no side stream exists."""
    frame = np.full((4, 6), 7, np.uint8)
    stager = streaming.HostStager("cpu", slots=2)
    one, stack = stager.put(frame), stager.put([frame, frame])
    frame[:] = 0
    assert stager._stream is None and one.event is None
    assert int(one.wait().sum()) == 7 * 24
    assert stack.wait().shape == (2, 4, 6) and int(stack.wait().min()) == 7


@pytest.mark.parametrize("n", [0, 1, 4])
def test_one_ahead_makes_the_next_item_first(n):
    """one_ahead hands every item on, in order, each only after the next
    has been made (the last at the end): the staging order of the
    streaming loops and the runner."""
    events = []

    def made():
        for i in range(n):
            events.append(("made", i))
            yield i

    for i in streaming.one_ahead(made()):
        events.append(("handed", i))
    want = [("made", 0)] if n else []
    for i in range(n):
        if i + 1 < n:
            want.append(("made", i + 1))
        want.append(("handed", i))
    assert events == want
