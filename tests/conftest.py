"""Test configuration: force an 8-virtual-device CPU platform.

Must run before the first `import jax` anywhere in the test session so that
sharding tests exercise a real multi-device mesh without accelerators
(SURVEY.md §4: multi-host is tested with mesh-shape parametrization on a
virtual device mesh).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
# Tests compile from scratch: entry points they drive (train.main) turn
# the persistent compilation cache on, and CPU executables written by
# one test worker are not worth sharing with the next.
jax.config.update("jax_enable_compilation_cache", False)


def pytest_addoption(parser):
    parser.addoption(
        "--slow", action="store_true", default=False,
        help="also run @pytest.mark.slow tests (the compile-heavy tier; "
             "RUN_SLOW=1 is equivalent). Default runs are the fast tier.")


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: `pytest -q` runs the fast tier
    (target <5 min); `pytest -q --slow` (or RUN_SLOW=1) runs everything —
    CI/driver and pre-commit-for-kernel-changes use the full run. An
    explicit -m expression disables the tiering entirely."""
    if (config.getoption("--slow") or os.environ.get("RUN_SLOW") == "1"
            or config.getoption("-m")):
        return
    skip = pytest.mark.skip(reason="slow tier (pass --slow or RUN_SLOW=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
