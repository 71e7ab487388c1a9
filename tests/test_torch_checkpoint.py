"""Two faults of the port, held on the CPU: an orbax checkpoint directory
(what slc_tpu writes when orbax is installed) raises a ValueError that
names it, in the library and through ``run --resume``; and every kernel
launch goes through ``_build.launch``, which enters
``torch.cuda.device`` of the tensors' device and raises on a non-zero
error (a fake library and a recording guard stand in for the card)."""

import contextlib
import os
import types

import numpy as np
import pytest
import torch

from slc_tpu_torch import checkpoint
from slc_tpu_torch.__main__ import main
from slc_tpu_torch.calib import build_tables, synthetic_calibration
from slc_tpu_torch.config import HeterodyneConfig, SystemConfig
from slc_tpu_torch.dynamic import TrackerState
from slc_tpu_torch.kernels import _build
from slc_tpu_torch.kernels import bilateral as kbil
from slc_tpu_torch.kernels import dynamic_step as kstep
from slc_tpu_torch.kernels import floors as kfl
from slc_tpu_torch.kernels import grayphase as kgray
from slc_tpu_torch.kernels import heterodyne as khet
from slc_tpu_torch.kernels import mgsmooth as kmg
from slc_tpu_torch.kernels import p2l as kp2l
from slc_tpu_torch.kernels import phaselock as kpl
from slc_tpu_torch.kernels import stripe as kstripe

torch.set_num_threads(2)


def _fake_orbax(root, n=5):
    """A directory laid out as orbax's StandardCheckpointer leaves one."""
    d = os.path.join(root, f"frame_{n}")
    os.makedirs(d)
    for name in ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt"):
        with open(os.path.join(d, name), "w") as f:
            f.write("{}")
    return d


def test_fake_orbax_directory_raises_naming_it(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    want = _fake_orbax(ckpt)
    latest = checkpoint.latest_checkpoint(ckpt)
    assert latest == want
    with pytest.raises(ValueError, match="orbax") as e:
        checkpoint.load_state(latest, device="cpu")
    assert want in str(e.value) and "npz" in str(e.value)


def test_npz_checkpoint_still_loads(tmp_path):
    st = TrackerState.from_numpy(
        {k: np.full((4, 5), i, np.float32)
         for i, k in enumerate(("proj_u", "strip_w", "strip_b", "z"))}
        | {"frame_idx": np.int32(7)}, "cpu")
    os.makedirs(tmp_path / "ckpt")
    path = checkpoint.save_state(str(tmp_path / "ckpt" / "frame_7"), st)
    latest = checkpoint.latest_checkpoint(str(tmp_path / "ckpt"))
    assert latest == path
    back = checkpoint.load_state(latest, device="cpu")
    assert back.frame_idx == 7
    assert torch.equal(back.strip_b, st.strip_b)


def test_orbax_checkpoint_written_by_slc_tpu_raises(tmp_path):
    """slc_tpu.checkpoint.save_state with orbax on writes a directory; the
    port finds it as the newest checkpoint and refuses it by name."""
    jcheckpoint = pytest.importorskip("slc_tpu.checkpoint")
    if not jcheckpoint._HAVE_ORBAX:
        pytest.skip("orbax is not installed")
    import jax.numpy as jnp
    from slc_tpu.dynamic import TrackerState as JState
    z = jnp.zeros((4, 5), jnp.float32)
    ckpt = str(tmp_path / "ckpt")
    path = jcheckpoint.save_state(os.path.join(ckpt, "frame_3"), JState(
        proj_u=z + 1, strip_w=z, strip_b=z, z=z + 50,
        frame_idx=jnp.int32(3)))
    assert os.path.isdir(path)
    latest = checkpoint.latest_checkpoint(ckpt)
    assert os.path.abspath(latest) == path
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.load_state(latest, device="cpu")


def test_run_resume_reports_an_orbax_checkpoint(tmp_path):
    ds, out = str(tmp_path / "ds"), str(tmp_path / "o")
    assert main(["synth", ds, "--frames", "3", "--cam", "48x64", "--pro",
                 "48x640", "--gray-bits", "5"]) == 0
    want = _fake_orbax(os.path.join(out, "ckpt"), 1)
    with pytest.raises(ValueError, match="orbax") as e:
        main(["run", ds, "--calib", os.path.join(ds, "parameters.yml"),
              "--out", out, "--out-format", "npz", "--device", "cpu",
              "--resume"])
    assert want in str(e.value)


class _FakeLib:
    """Records each entry point's arguments; returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        if name == "slc_dynamic_step_lock_scratch":
            return lambda h, w, band: 2 * h * w + 64
        if name == "slc_error_string":
            return lambda err: b"fake failure"
        if not name.startswith("slc_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.err
        return entry


@pytest.fixture
def guarded(monkeypatch):
    """A fake library, stream and ``torch.cuda.device`` that record which
    device each launch was made under."""
    fake = _FakeLib()
    entered = []

    @contextlib.contextmanager
    def device(d):
        entered.append(torch.device(d))
        yield

    monkeypatch.setattr(_build, "_lib", fake)
    monkeypatch.setattr(_build, "stream_of", lambda d: 4242)
    monkeypatch.setattr(torch.cuda, "device", device)
    return fake, entered


def test_launch_enters_the_tensors_device(guarded):
    fake, entered = guarded
    _build.launch("slc_bilateral", torch.device("cuda", 1), 1, 2, 3)
    assert entered == [torch.device("cuda", 1)]
    assert fake.calls == [("slc_bilateral", (1, 2, 3, 4242))]


def test_launch_raises_on_an_error(guarded):
    fake, entered = guarded
    fake.err = 700
    with pytest.raises(RuntimeError, match="slc_stripe: CUDA error 700 "
                                           r"\(fake failure\)"):
        _build.launch("slc_stripe", torch.device("cuda", 0), 7)
    assert entered == [torch.device("cuda", 0)]


def _wrapper_calls():
    """Each kernel wrapper on small CPU tensors, with its C entry point."""
    h, w = 24, 40
    cfg = SystemConfig(cam_h=h, cam_w=w, pro_h=24, pro_w=640, gray_bits=5)
    tables = build_tables(synthetic_calibration(cam_h=h, cam_w=w, pro_h=24,
                                                pro_w=640), h, w, "cpu")
    u8 = torch.zeros((h, w), dtype=torch.uint8)
    f = torch.zeros((h, w))
    het = HeterodyneConfig()
    lvl = (f, torch.zeros((h - 1, w)), torch.zeros((h, w - 1)), f)
    return {
        "slc_grayphase": lambda: kgray.grayphase_decode_cuda(
            torch.zeros((10, h, w), dtype=torch.uint8),
            torch.zeros((4, h, w), dtype=torch.uint8), tables, cfg),
        "slc_stripe": lambda: kstripe.stripe_regression_cuda(u8, 21),
        "slc_dynamic_step": lambda: kstep.dynamic_step_open_cuda(
            u8, f, f, f, tables),
        "slc_dynamic_step_lock": lambda: kstep.dynamic_step_lock_cuda(
            u8, f, f, f, tables),
        "slc_heterodyne": lambda: khet.heterodyne_decode_cuda(
            torch.zeros((het.num_images, h, w), dtype=torch.uint8), tables,
            cfg, het),
        "slc_bilateral": lambda: kbil.bilateral_filter_cuda(f),
        "slc_mg_down": lambda: kmg.mg_down_cuda(*lvl),
        "slc_mg_up": lambda: kmg.mg_up_cuda(f, *lvl),
        "slc_mg_coarse": lambda: kmg.mg_coarse_cuda(*lvl),
        "slc_phase_lock": lambda: kpl.phase_lock_cuda(u8, f, tables,
                                                      period=12.0),
        "slc_halo_block_floor_u8": lambda: kfl.halo_block_floor_cuda(u8),
        "slc_p2l_step": lambda: kp2l.gn_step_p2l_cuda(
            torch.zeros((3, 3, 3)), torch.zeros((3, 3)), torch.zeros((8, 3)),
            torch.zeros((8, 3)), torch.zeros((3, 8, 3)), torch.zeros((3, 8)),
            1e-3, _cpu_p2l_work(3, 8)),
    }


def _cpu_p2l_work(views, landmarks):
    """A ``P2LWork``'s buffers on the CPU (the class asks the card for its
    SM count)."""
    work = types.SimpleNamespace(views=views, landmarks=landmarks, blocks=1)
    for name, shape in (("part1", (views * kp2l.STATS,)),
                        ("part2", (views * kp2l.TERMS,)),
                        ("center", (views, 3)), ("rot", (views, 3, 3)),
                        ("trans", (views, 3))):
        setattr(work, name, torch.zeros(shape))
    work.info = torch.zeros((), dtype=torch.int64)
    return work


@pytest.mark.parametrize("entry", [
    "slc_bilateral", "slc_dynamic_step", "slc_dynamic_step_lock",
    "slc_grayphase", "slc_halo_block_floor_u8", "slc_heterodyne",
    "slc_mg_coarse", "slc_mg_down", "slc_mg_up", "slc_p2l_step",
    "slc_phase_lock", "slc_stripe"])
def test_every_wrapper_launches_under_the_guard(guarded, monkeypatch,
                                                entry):
    """With the CUDA-only input checks lifted, each wrapper's one C call
    goes through ``_build.launch``: made under the guard of its tensors'
    device, with the stream as its last argument."""
    fake, entered = guarded
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    _wrapper_calls()[entry]()
    assert [name for name, _ in fake.calls] == [entry]
    assert fake.calls[0][1][-1] == 4242
    assert entered == [torch.device("cpu")]
