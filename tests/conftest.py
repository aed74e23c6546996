"""Test harness config: run JAX on a virtual 8-device CPU mesh so multi-device
sharding paths compile and execute without GPUs, with the Pallas scan kernel
in interpret mode (FAC_INTERPRET=1: without it the device lanes refuse to run
off a GPU).

Tests marked ``gpu`` compile the kernel for a real card; they skip here and
run on a GPU host with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("FAC_INTERPRET", "1")
# A per-session cache directory (compile cache + the persisted capacity
# cache, ops/packed_bitap._cap_cache): tests build hundreds of tiny engines,
# and a converged capacity from an earlier run must not seed this one.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR", tempfile.mkdtemp(prefix="fac_cache_")
)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# --- fast default subset -----------------------------------------------------
# The heaviest interpret-mode differential tests are marked ``slow`` and
# skipped by default so the standard `pytest tests/` run stays short. The
# full job (and any local run) re-enables them with FAC_FULL_TESTS=1 or
# `-m slow`.

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy interpret-mode differential suites; skipped unless "
        "FAC_FULL_TESTS=1 or an explicit -m expression selects them",
    )
    config.addinivalue_line(
        "markers",
        "gpu: compiles the kernels for a real GPU; skipped without one",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("FAC_FULL_TESTS") == "1":
        return
    if config.getoption("-m"):
        return  # an explicit marker expression overrides the default skip
    skip = pytest.mark.skip(
        reason="slow differential suite: run with FAC_FULL_TESTS=1"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided when the test
    runs, never at import). Turns interpret mode off for the test."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
    mp = pytest.MonkeyPatch()
    mp.delenv("FAC_INTERPRET", raising=False)
    yield jax.devices()[0]
    mp.undo()
