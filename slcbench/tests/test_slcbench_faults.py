"""The harness at test size on the CPU with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have.
A tracker step that returns its state unchanged; a depth map altered
where the program produces it (in the tracker step, in the decode), or
in one band of the rows only; a decode that hands back a stale map. (No
cell has a batch whose half could be left out, nor an exchange between
chips.)"""

import dataclasses

import pytest
import torch

import slcbench_small as small
import slc_tpu_torch.dynamic as pdynamic
import slc_tpu_torch.pipeline as ppipeline


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return small.make(tmp_path_factory.mktemp("bench"))


def _altered(res, dz=0.05):
    return dataclasses.replace(res, z=torch.where(res.z > 0, res.z + dz,
                                                  res.z))


def _unchanged_step(real):
    def step(state, frame, *a, **k):
        _, res = real(state, frame, *a, **k)
        return state, dataclasses.replace(res, z=state.z)
    return step


def _altered_step(real):
    def step(state, frame, *a, **k):
        st, res = real(state, frame, *a, **k)
        return st, _altered(res)
    return step


def _banded_step(real):
    """z altered in one band of an eighth of the rows only."""
    def step(state, frame, *a, **k):
        st, res = real(state, frame, *a, **k)
        band = torch.zeros_like(res.z, dtype=torch.bool)
        band[: res.z.shape[0] // 8] = True
        return st, dataclasses.replace(
            res, z=torch.where(band & (res.z > 0), res.z + 0.05, res.z))
    return step


def _altered_decode(real):
    def decode(*a, **k):
        return _altered(real(*a, **k))
    return decode


def _stale_decode(real):
    first = []

    def decode(*a, **k):
        res = real(*a, **k)
        if not first:
            first.append(res)
        return first[0]
    return decode


FAULTS = [
    ("tiny_gray.track", pdynamic, "dynamic_step", _unchanged_step),
    ("tiny_het.track", pdynamic, "dynamic_step", _unchanged_step),
    ("tiny_gray.track", pdynamic, "dynamic_step", _altered_step),
    ("tiny_gray.track", pdynamic, "dynamic_step", _banded_step),
    ("tiny_het.track", ppipeline, "decode_heterodyne_frame",
     _altered_decode),
    ("tiny_gray.scan", ppipeline, "decode_first_frame", _altered_decode),
    ("tiny_het.scan", ppipeline, "decode_heterodyne_frame", _altered_decode),
    ("tiny_gray.scan", ppipeline, "decode_first_frame", _stale_decode),
]


@pytest.mark.parametrize("cell,module,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, module,
                                           name, fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    out = small.run(tiny, cell, seed=4242, seconds=0.4)
    assert out["correct"] is False, out["checks"]
