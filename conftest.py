"""Build slc_tpu's native I/O library once, before any test collects.

``tests/test_native_loader.py`` decides while it is collected whether the
library loads (``skipif(native_io.lib() is None)``), and a missing
library is built by ``slc_tpu/io/native/__init__.py`` with a plain
``g++ -o``. Under pytest-xdist every worker collects that module at the
same time, so one worker could load another's half-written file, get
None and skip all of its tests. Here the xdist controller (or the only
process, without xdist) builds the library before the workers start.

The module is loaded by file path: importing ``slc_tpu`` would import
jax before tests/conftest.py sets its environment. Where the file is
missing (a checkout of the port alone) this does nothing; with no g++
the build fails as before and those tests still skip.
"""

import importlib.util
import os

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "slc_tpu", "io", "native", "__init__.py")


def pytest_configure(config):
    if hasattr(config, "workerinput") or not os.path.exists(_NATIVE):
        return
    spec = importlib.util.spec_from_file_location("_slc_tpu_native_build",
                                                  _NATIVE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.lib()
