"""Make optional deps optional: tier-1 must collect on a clean container.

If `hypothesis` is importable it is used unchanged; otherwise the shim in
_hypothesis_compat.py is registered under its name BEFORE test modules
import it, degrading `@given` property sweeps to fixed parametrized
examples.
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
import sys

# Hermetic autotuner: no kernel benchmarking at first touch and no writes to
# the user-level disk cache during the suite.  Tests that exercise the
# autotuner override these per-test via monkeypatch.setenv.
os.environ["REPRO_AUTOTUNE"] = "0"
os.environ["REPRO_AUTOTUNE_CACHE"] = "off"


def _install_hypothesis_shim() -> None:
    try:
        import hypothesis  # noqa: F401
        return
    except ImportError:
        pass
    path = pathlib.Path(__file__).with_name("_hypothesis_compat.py")
    spec = importlib.util.spec_from_file_location("hypothesis", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules["hypothesis"] = mod


_install_hypothesis_shim()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips inside the test without one")
