"""Builds the native ingest library once, before any test worker starts.

In a fresh checkout csrc/libtsingest.so does not exist yet (it is built
on first use). Under pytest-xdist every worker would otherwise reach a
loader during collection and run `make -C csrc` at the same time, and a
worker could map the library while another one relinks it. Building it
here, in the controller (or in a run without xdist), leaves every worker
a fresh library, so no loader runs make.

The port's `_native.py` is loaded by its path, so the package `__init__`
(which imports torch) does not run: a machine without torch runs the JAX
package's tests as before.
"""
import importlib.util
import os


def _load_native():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tensor_stream_torch", "_native.py")
    spec = importlib.util.spec_from_file_location("_ts_native_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    native = _load_native()
    try:
        native.build()
    except native.NativeBuildError:
        pass  # the tests that need the library fail as they would anyway
