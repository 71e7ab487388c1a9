"""slc_tpu_torch.parallel on gloo ranks on the CPU: each case of
tests/test_parallel.py at its own shapes and meshes, held against the
port's single-device function at test_parallel.py's bars (bit-exact
decodes and stripe regression; P 1e-4 and z 1e-3 for the steps; 1e-3
for unwrap, its counts equal and cg_iters within one; 1e-4 for fusion),
and against slc_tpu's tiled function on the 8 virtual CPU devices
(tests/conftest.py) at the bars the port's single-device parity tests
hold for the same function (test_torch_decode.py, test_torch_heterodyne.py,
test_torch_stripe.py, test_torch_dynamic.py, test_torch_unwrap_spatial.py,
test_torch_fusion.py).

One 8-rank cluster serves the module; its ranks run the tasks of
tests/torch_parallel_tasks.py, which imports neither jax nor slc_tpu.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import assert_heterodyne_parity

from slc_tpu import calib as jcalib
from slc_tpu import fusion as jfusion
from slc_tpu import synth as jsynth
from slc_tpu.config import HeterodyneConfig as JHet
from slc_tpu.config import SystemConfig as JConfig
from slc_tpu.dynamic import TrackerState as JState
from slc_tpu.dynamic import init_tracker as j_init
from slc_tpu.parallel import (shard_image as j_shard, tile_mesh as j_mesh,
                              tiled_absolute_decode as j_absolute,
                              tiled_batched_dynamic_step as j_batched,
                              tiled_dynamic_step as j_step,
                              tiled_heterodyne_decode as j_het,
                              tiled_stripe_regression as j_stripe,
                              tiled_unwrap_spatial as j_unwrap)

import torch_parallel_tasks as tasks
from slc_tpu_torch import calib as tcalib
from slc_tpu_torch import fusion
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.dynamic import TrackerState, dynamic_step
from slc_tpu_torch.kernels.stripe import stripe_regression
from slc_tpu_torch.ops.unwrap_spatial import unwrap_spatial
from slc_tpu_torch.parallel import (gather_image, shard_image,
                                    tiled_absolute_decode,
                                    tiled_dynamic_step,
                                    tiled_stripe_regression,
                                    tiled_unwrap_spatial)
from slc_tpu_torch.parallel.launch import LocalCluster
from slc_tpu_torch.parallel.mesh import mesh_shape, tile_mesh
from slc_tpu_torch.pipeline import (decode_first_frame,
                                    decode_heterodyne_frame)

torch.set_num_threads(2)

KW = dict(cam_h=96, cam_w=160, pro_h=96, pro_w=640, gray_bits=5,
          phase_steps=4)
CFG = SystemConfig(**KW)
JCFG = JConfig(**KW)
STATE = ("proj_u", "strip_w", "strip_b", "z", "frame_idx")


@pytest.fixture(scope="module")
def cluster():
    with LocalCluster(8, device="cpu", timeout_s=120) as c:
        yield c


@pytest.fixture(scope="module")
def rig():
    calib = jcalib.synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                         pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    tcal = tcalib.synthetic_calibration(cam_h=CFG.cam_h, cam_w=CFG.cam_w,
                                        pro_h=CFG.pro_h, pro_w=CFG.pro_w)
    return (calib, jcalib.build_tables(calib, CFG.cam_h, CFG.cam_w),
            tcalib.build_tables(tcal, CFG.cam_h, CFG.cam_w, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _first(results):
    """Every rank gathered the same global result: return rank 0's."""
    for r in results[1:]:
        for a, b in zip(_leaves(results[0]), _leaves(r)):
            np.testing.assert_array_equal(a, b)
    return results[0]


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [np.asarray(x)]


def _state(frames, pus, zs):
    """slc_tpu's tracker after frame 0, as numpy (its XLA path)."""
    st = j_init(jnp.asarray(frames[0]), jnp.asarray(pus[0], jnp.float32),
                jnp.asarray(zs[0], jnp.float32), JCFG, use_pallas=False)
    return {k: np.asarray(getattr(st, k)) for k in STATE}


def test_tile_mesh_shapes(cluster):
    flat, grouped = _first(cluster.run(tasks.mesh_shapes))
    assert flat["scan"] == 1 and flat["ty"] * flat["tx"] == 8
    assert (flat["ty"], flat["tx"]) == (2, 4)
    assert grouped == {"scan": 2, "ty": 2, "tx": 2}
    assert mesh_shape(12) == (1, 3, 4)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape(8, scan=3)
    with pytest.raises(ValueError, match="devices-per-scan"):
        mesh_shape(8, tiles=(3, 3))
    assert tile_mesh() is None                 # no process group here
    with pytest.raises(RuntimeError, match="process group"):
        tile_mesh(8)


def test_ranks_import_neither_jax_nor_slc_tpu(cluster):
    for mods in cluster.run(tasks.foreign_modules):
        assert mods == []


@pytest.mark.parametrize("tiles", [(2, 4), (4, 2)])
def test_shard_and_gather_image_round_trip(cluster, tiles):
    x = np.arange(3 * 96 * 160, dtype=np.float32).reshape(3, 96, 160)
    results = cluster.run(tasks.round_trip, x, tiles)
    for shape, back in results:
        assert shape == (3, 96 // tiles[0], 160 // tiles[1])
        np.testing.assert_array_equal(back, x)


def test_tiled_absolute_decode_matches_single(cluster, eight_devices, rig):
    calib, jt, tt = rig
    scene = jsynth.render_static_scene(calib, JCFG,
                                       jsynth.plane_surface(50.0))
    got = _first(cluster.run(tasks.absolute, scene.gray_images,
                             scene.phase_images, CFG, (2, 4)))
    ref = decode_first_frame(_t(scene.gray_images), _t(scene.phase_images),
                             tt, CFG)
    for k in ("proj_u", "z", "x", "y"):
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy())

    mesh = j_mesh(eight_devices, tiles=(2, 4))
    want = j_absolute(j_shard(jnp.asarray(scene.gray_images), mesh),
                      j_shard(jnp.asarray(scene.phase_images), mesh), jt,
                      JCFG, mesh)
    np.testing.assert_allclose(got["proj_u"], np.asarray(want.proj_u),
                               atol=2e-3)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)),
                                   atol=8e-3)


def test_tiled_heterodyne_decode_matches_single(cluster, eight_devices, rig):
    calib, jt, tt = rig
    het, jhet = HeterodyneConfig(), JHet()
    imgs, _, _ = jsynth.render_fringe_stack(
        calib, JCFG, jsynth.plane_surface(55.0, 0.1, 0.05),
        jhet.periods(JCFG.pro_w), jhet.phase_steps, noise_sigma=1.0)
    got = _first(cluster.run(tasks.heterodyne, imgs, CFG, het, (2, 4)))
    ref = decode_heterodyne_frame(_t(imgs), tt, CFG, het)
    for k in ("proj_u", "z", "x", "y"):
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy())

    mesh = j_mesh(eight_devices, tiles=(2, 4))
    want = j_het(j_shard(jnp.asarray(imgs), mesh), jt, JCFG, jhet, mesh)
    m = assert_heterodyne_parity(got["proj_u"], np.asarray(want.proj_u),
                                 JCFG.pro_w / 64, max_divergent=8)
    for k, bar in (("z", 4e-3), ("x", 4e-3), ("y", 1e-3)):
        np.testing.assert_allclose(got[k][m], np.asarray(getattr(want, k))[m],
                                   atol=bar)


@pytest.mark.parametrize("subpixel", [False, True])
def test_tiled_stripe_regression_matches_single(cluster, eight_devices, rng,
                                                subpixel):
    frame = rng.integers(0, 256, size=(CFG.cam_h, CFG.cam_w), dtype=np.uint8)
    got_w, got_b = _first(cluster.run(tasks.stripe, frame, CFG, (4, 2),
                                      subpixel))
    ref_w, ref_b = stripe_regression(_t(frame), CFG.reco_window, subpixel)
    np.testing.assert_array_equal(got_w, ref_w.numpy())
    np.testing.assert_array_equal(got_b, ref_b.numpy())

    mesh = j_mesh(eight_devices, tiles=(4, 2))
    want_w, want_b = j_stripe(j_shard(jnp.asarray(frame), mesh), JCFG, mesh,
                              subpixel)
    np.testing.assert_allclose(got_w, np.asarray(want_w), atol=1e-5)
    np.testing.assert_allclose(got_b, np.asarray(want_b), atol=1e-5)


def test_tiled_dynamic_step_matches_single(cluster, eight_devices, rig):
    calib, jt, tt = rig
    frames, zs, pus = jsynth.render_dynamic_sequence(
        calib, JCFG, 3, z0=50.0, dz_per_frame=0.5, stripe_period=12)
    state = _state(frames, pus, zs)
    got = _first(cluster.run(tasks.dynamic, state, frames[1:], CFG, (2, 4)))

    st = TrackerState.from_numpy(state, device="cpu")
    mesh = j_mesh(eight_devices, tiles=(2, 4))
    jst = jax.tree.map(lambda a: j_shard(jnp.asarray(a), mesh)
                       if a.ndim == 2 else jnp.array(a),
                       j_init(jnp.asarray(frames[0]),
                              jnp.asarray(pus[0], jnp.float32),
                              jnp.asarray(zs[0], jnp.float32), JCFG,
                              use_pallas=False))
    for f, g in zip(frames[1:], got):
        st, ref = dynamic_step(st, _t(f), tt, CFG)
        np.testing.assert_allclose(g["proj_u"], ref.proj_u.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(g["z"], ref.z.numpy(), atol=1e-3)
        jst, want = j_step(jst, j_shard(jnp.asarray(f), mesh), jt, JCFG,
                           mesh)
        np.testing.assert_allclose(g["proj_u"], np.asarray(want.proj_u),
                                   atol=2e-4)
        np.testing.assert_allclose(g["z"], np.asarray(want.z), atol=2e-3)
        for k in ("x", "y"):
            np.testing.assert_allclose(g[k], np.asarray(getattr(want, k)),
                                       atol=2e-4)
        for k in ("strip_w", "strip_b"):
            np.testing.assert_allclose(g[k], np.asarray(getattr(jst, k)),
                                       atol=1e-5)


def test_tiled_batched_step_dp_and_metrics(cluster, eight_devices, rig):
    """scan=2 groups x 2x2 tiles, a different scan per group: each group
    evolves its own sequence; the metrics are reduced over every rank."""
    calib, jt, tt = rig
    seqs = [jsynth.render_dynamic_sequence(
        calib, JCFG, 2, z0=50.0 + 2.0 * s, dz_per_frame=0.5,
        stripe_period=12) for s in range(2)]
    init = [_state(f, p, z) for f, p, z in seqs]
    states = {k: np.stack([i[k] for i in init]) for k in STATE}
    frames = np.stack([f[1] for f, _, _ in seqs])
    got = _first(cluster.run(tasks.batched, states, frames, CFG, 2, (2, 2)))
    assert got["frame_idx"] == 1

    valid = []
    for s in range(2):
        _, ref = dynamic_step(TrackerState.from_numpy(init[s], device="cpu"),
                              _t(frames[s]), tt, CFG)
        np.testing.assert_allclose(got["z"][s], ref.z.numpy(), atol=1e-3)
        np.testing.assert_allclose(got["proj_u"][s], ref.proj_u.numpy(),
                                   atol=1e-4)
        valid.append(float((ref.z > 0).float().mean()))
    assert abs(got["valid_frac"] - np.mean(valid)) < 1e-5

    mesh = j_mesh(eight_devices, scan=2, tiles=(2, 2))
    s3 = NamedSharding(mesh, P("scan", "ty", "tx"))
    jstates = JState(**{k: jax.device_put(jnp.asarray(states[k]), s3)
                        for k in STATE[:4]},
                     frame_idx=jnp.zeros((2,), jnp.int32))
    _, want, met = j_batched(jstates, jax.device_put(jnp.asarray(frames), s3),
                             jt, JCFG, mesh)
    np.testing.assert_allclose(got["z"], np.asarray(want.z), atol=2e-3)
    np.testing.assert_allclose(got["proj_u"], np.asarray(want.proj_u),
                               atol=2e-4)
    assert abs(got["valid_frac"] - float(met["valid_frac"])) < 1e-5
    assert abs(got["mean_z"] - float(met["mean_z"])) < 1e-3


def _ramp_scene():
    t, h, w = 32.0, 96, 128
    x = (np.linspace(0, 5 * t, w)[None, :]
         + 0.4 * np.arange(h)[:, None]).astype(np.float32)
    psi = np.mod(x, t).astype(np.float32)
    q = np.ones((h, w), np.float32)
    q[40:48] = 1e-3
    good = np.ones((h, w), bool)
    good[40:48] = False
    return t, x, psi, q, x, good, 400


def _box_scene():
    from tests.test_unwrap_spatial import _box_step_scene
    rng = np.random.default_rng(1234)
    t = 32.0
    x, psi, _, ring = _box_step_scene(rng, t=t, noise=0.05)
    q = np.ones(psi.shape, np.float32)
    q[ring] = 0.0
    anchor = (x + rng.uniform(-t / 3, t / 3, x.shape)).astype(np.float32)
    return t, x, psi, q, anchor, ~ring, 800


@pytest.mark.parametrize("scene", [_ramp_scene, _box_scene],
                         ids=["ramp", "box_step"])
def test_tiled_unwrap_spatial_matches_single(cluster, eight_devices, scene):
    """Distributed CG: the same operator and lockstep scalars, so the
    single-device solver's fringe orders and diagnostic counts, and its
    iteration count up to one (the all-reduced dots sum the tiles'
    partials in another order)."""
    t, x, psi, q, anchor, good, iters = scene()
    got = _first(cluster.run(tasks.unwrap, psi, t, q, anchor, (2, 4),
                             iters))
    ref, info = unwrap_spatial(_t(psi), t, quality=_t(q), max_iters=iters,
                               anchor=_t(anchor), return_info=True)
    np.testing.assert_allclose(got["p"][good], ref.numpy()[good], atol=1e-3)
    if scene is _ramp_scene:                   # noiseless: P is x
        np.testing.assert_allclose(got["p"][good], x[good], atol=1e-2)
    for k in ("residue_count", "suspect_count", "anchor_disagreement_count"):
        assert got[k] == int(info[k]), k
    assert abs(got["cg_iters"] - info["cg_iters"]) <= 1

    mesh = j_mesh(eight_devices, tiles=(2, 4))
    want, jinfo = j_unwrap(j_shard(jnp.asarray(psi), mesh), t, mesh,
                           quality=j_shard(jnp.asarray(q), mesh),
                           max_iters=iters,
                           anchor=j_shard(jnp.asarray(anchor), mesh),
                           return_info=True)
    want = np.asarray(want)
    assert (np.abs(got["p"] - want) > t / 2).sum() == 0
    np.testing.assert_allclose(got["p"], want, atol=1e-3)
    assert abs(got["cg_iters"] - int(jinfo["cg_iters"])) <= 1
    for k in ("residue_count", "suspect_count", "anchor_disagreement_count"):
        assert got[k] == int(jinfo[k]), k


def test_tiled_step_collective_bytes(cluster, eight_devices):
    """The port's counted exchange of one batched step at 128x256 on 2x4:
    halo-dominated and a small fraction of the tile's device-memory
    footprint (test_parallel.py:248-253), and exactly the slabs the step
    exchanges: the frame's 12-px halo (u8: 2*12*64 + 2*88*12), the two
    strips' 1-px halos (f32: 2*(2*64 + 2*66)*4 each) and P's x halo
    (2*64*4), 6,240 B per tile; the metrics' all-reduce 8 B."""
    from slc_tpu.devtime import hlo_collective_bytes

    h, w = 128, 256
    kw = dict(cam_h=h, cam_w=w, pro_h=h, pro_w=640, gray_bits=5)
    stats = cluster.run(tasks.step_bytes, SystemConfig(**kw), (2, 4), 0)
    hbm = 37 * h * w // 8
    for s in stats:
        assert s["ops"] > 0
        assert s["collective-permute"] == 6240, s
        assert s["all-reduce"] == 8, s
        assert s["collective-permute"] > 100 * s["all-reduce"]
        assert s["collective-permute"] < 0.1 * hbm, s
        assert s["total"] == s["collective-permute"] + s["all-reduce"]

    cfg = JConfig(**kw)
    calib = jcalib.synthetic_calibration(cam_h=h, cam_w=w, pro_h=h,
                                         pro_w=640)
    mesh = j_mesh(eight_devices, scan=1, tiles=(2, 4))
    sh = NamedSharding(mesh, P(None, "ty", "tx"))
    rng = np.random.default_rng(0)

    def put(a):
        return jax.device_put(a[None], sh)

    state = JState(*(put(rng.uniform(0, 100, (h, w)).astype(np.float32))
                     for _ in range(4)), frame_idx=jnp.zeros((1,), jnp.int32))
    txt = jax.jit(lambda st, fr: j_batched(
        st, fr, jcalib.build_tables(calib, h, w), cfg, mesh)).lower(
        state, put(rng.integers(0, 256, (h, w), np.uint8))).compile(
        ).as_text()
    print(f"collective bytes per tile: port {stats[0]}, slc_tpu's HLO "
          f"{hlo_collective_bytes(txt)}")


def test_tiled_fuse_scans_matches_single(cluster):
    """Landmark-sharded fusion on 8 ranks against the single-device
    solver at the same damping (1e-4) and against slc_tpu's tiled solver
    (test_torch_fusion.py's fuse_scans bars)."""
    from slc_tpu.parallel.fusion_tiled import (fusion_mesh, shard_landmarks,
                                               tiled_fuse_scans)
    obs, mask, _, _ = jfusion.synthetic_problem(np.random.default_rng(5),
                                                s=16, l=128, noise=0.01)
    obs, mask = np.asarray(obs), np.asarray(mask)
    rot, trans, lm = _first(cluster.run(tasks.fuse, obs, mask, 10))
    r1, t1, lm1 = fusion.fuse_scans(_t(obs), _t(mask), iters=10,
                                    damping=1e-6)
    np.testing.assert_allclose(rot, r1.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(trans, t1.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lm, lm1.numpy(), rtol=0, atol=1e-4)

    mesh = fusion_mesh(jax.devices())
    wr, wt, _ = tiled_fuse_scans(*shard_landmarks(mesh, obs, mask), mesh,
                                 iters=10)
    np.testing.assert_allclose(rot, np.asarray(wr), rtol=0, atol=1e-4)
    np.testing.assert_allclose(trans, np.asarray(wt), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(wt)).max())


def test_one_rank_mesh_is_the_single_device_path(rig, rng):
    """Without a process group the mesh is None (1x1x1): zero halos and
    identity reductions give the single-device results in this process."""
    calib, _, tt = rig
    scene = jsynth.render_static_scene(calib, JCFG, jsynth.plane_surface(50.0))
    got = tiled_absolute_decode(_t(scene.gray_images),
                                _t(scene.phase_images), tt, CFG, None)
    ref = decode_first_frame(_t(scene.gray_images), _t(scene.phase_images),
                             tt, CFG)
    for k in ("proj_u", "z", "x", "y"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    frame = _t(rng.integers(0, 256, (CFG.cam_h, CFG.cam_w), np.uint8))
    for a, b in zip(tiled_stripe_regression(frame, CFG, None),
                    stripe_regression(frame, CFG.reco_window, True)):
        assert torch.equal(a, b)

    frames, zs, pus = jsynth.render_dynamic_sequence(
        calib, JCFG, 2, z0=50.0, dz_per_frame=0.5, stripe_period=12)
    st = TrackerState.from_numpy(_state(frames, pus, zs), device="cpu")
    new, res = tiled_dynamic_step(st, _t(frames[1]), tt, CFG, None)
    new_ref, ref = dynamic_step(st, _t(frames[1]), tt, CFG)
    np.testing.assert_allclose(res.proj_u.numpy(), ref.proj_u.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(res.z.numpy(), ref.z.numpy(), atol=1e-3)
    assert torch.equal(new.strip_w, new_ref.strip_w)

    t, x, psi, q, anchor, good, iters = _box_scene()
    got, info = tiled_unwrap_spatial(_t(psi), t, None, quality=_t(q),
                                     max_iters=iters, anchor=_t(anchor),
                                     return_info=True)
    want, winfo = unwrap_spatial(_t(psi), t, quality=_t(q), max_iters=iters,
                                 anchor=_t(anchor), return_info=True)
    np.testing.assert_allclose(got.numpy()[good], want.numpy()[good],
                               atol=1e-3)
    assert abs(info["cg_iters"] - winfo["cg_iters"]) <= 1
    assert int(info["suspect_count"]) == int(winfo["suspect_count"])
    assert torch.equal(gather_image(got, None), got)
    assert torch.equal(shard_image(got, None), got)
