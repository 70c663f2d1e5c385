"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh: multi-chip sharding logic is
validated without accelerators, and numerics are exact f32 so
oracle-parity tests are deterministic. Where JAX_PLATFORMS names another
platform (`JAX_PLATFORMS=cuda python -m pytest -m chip tests/`), that
platform is used instead, and the tests marked `chip` run on the card.
"""

import os

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_platforms", "cpu")

from openpose_plus.utils.compile_cache import configure_compile_cache  # noqa: E402

# Persistent compile cache: the suite is compile-bound on small hosts
# (dozens of engine/train-step programs at seconds each).
configure_compile_cache(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache_cpu"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: compile-heavy test (multiprocess, train-loop e2e, kungfu "
        "learning); skipped by default, run with --runslow or -m slow")
    config.addinivalue_line(
        "markers",
        "chip: needs a GPU; skips elsewhere (the `gpu` fixture decides). "
        "Run on the card with JAX_PLATFORMS=cuda python -m pytest -m chip "
        "tests/")


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (CI always does; see Makefile)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    if config.getoption("-m"):
        return  # explicit marker expression wins (e.g. `-m slow`)
    skip = pytest.mark.skip(reason="slow: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda python -m pytest "
                    "-m chip tests/)")
    return jax.devices()[0]
