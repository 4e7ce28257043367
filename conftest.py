"""Root conftest: the tests run on the CPU, on 8 virtual devices.

The suite checks arithmetic, shapes and sharding rules, which the CPU
backend shows as well as a card does, and its parallel workers must never
open a GPU.  The multi-device schedules run on a virtual 8-device host
mesh; the real device path is exercised by ``python chip_smoke.py``.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# pin the platform in JAX's config as well as the environment, so that a
# GPU plugin installed beside JAX is never initialized by a test worker
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(__file__))

from gemini_seal import compile_cache  # noqa: E402

compile_cache.enable()

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "bootstrap_e2e: full CKKS bootstrap refresh — hour-scale XLA "
        "compile on a single host core; opt in with GST_BOOTSTRAP_E2E=1 "
        "(tools/run_bootstrap_e2e.sh)",
    )
    config.addinivalue_line(
        "markers",
        "slow: minutes-scale single test (runs by default; deselect with "
        "-m 'not slow' for a quick sweep)",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("GST_BOOTSTRAP_E2E") == "1":
        return
    skip = pytest.mark.skip(
        reason="hour-scale compile; set GST_BOOTSTRAP_E2E=1 to run"
    )
    for item in items:
        if "bootstrap_e2e" in item.keywords:
            item.add_marker(skip)
