"""Nothing the benchmark runs loads JAX or ``slc_tpu``: the check compares
whole top-level module names (``slc_tpu_torch`` is the program), the
modules the harness imports leave none loaded, and no file of the
benchmark imports them. The reference imports nothing of the program.
A run that loads one anywhere, its check included, prints no result."""

import ast
import os
import subprocess
import sys
import types

import pytest

import slcbench_small as small
from slcbench import harness

ROOT = os.path.dirname(harness.HERE)


def test_top_level_names_are_compared_whole():
    mods = {"slc_tpu_torch": 1, "slc_tpu_torch.dynamic": 1, "jaxtyping": 1,
            "slc_tpu_tools": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules({"slc_tpu.pallas": 1, "jax": 1,
                                      "jaxlib.xla": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib.xla", "slc_tpu.pallas"]


def test_the_harness_loads_neither():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from slcbench import harness, program, compare, scenes, trace\n"
        "from slcbench.reference import plain\n"
        "import glob, os\n"
        "for kind in ('drivers', 'metrics'):\n"
        "    for p in glob.glob(os.path.join(harness.HERE, kind, '*.py')):\n"
        "        harness.load_module(harness.HERE, kind,\n"
        "            os.path.basename(p)[:-3])\n"
        "print(harness.forbidden_modules())\n" % ROOT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _files():
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_file_imports_jax_or_slc_tpu():
    for path in _files():
        if os.sep + "tests" + os.sep in path:
            continue
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)
        for mod in ("bench", "chip_smoke", "tools"):
            assert mod not in set(_imports(path)), (path, mod)


def test_the_yardstick_imports_nothing_of_the_program():
    d = harness.HERE
    yardstick = [os.path.join(d, "reference", "plain.py"),
                 os.path.join(d, "compare.py"), os.path.join(d, "scenes.py"),
                 os.path.join(d, "trace.py"), os.path.join(d, "metric_lib.py")]
    for path in yardstick + [os.path.join(d, "metrics", f)
                             for f in os.listdir(os.path.join(d, "metrics"))]:
        assert "slc_tpu_torch" not in set(_imports(path)), path


@pytest.mark.parametrize("name", ["jax", "slc_tpu.pallas"])
def test_a_module_loaded_by_the_check_ends_the_run(tmp_path, monkeypatch,
                                                   name):
    d = small.make(tmp_path)
    real = harness.make_driver

    def make_driver(cell, bench_dir):
        drv = real(cell, bench_dir)
        check = drv.check

        def loading_check():
            monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
            return check()
        drv.check = loading_check
        return drv
    monkeypatch.setattr(harness, "make_driver", make_driver)
    with pytest.raises(RuntimeError, match="JAX"):
        small.run(d, "tiny_gray.scan", seconds=0.3)
