"""Test harness config: JAX on the CPU with 8 virtual devices by default.

Multi-device sharding paths are exercised without a GPU cluster via the
standard JAX trick (xla_force_host_platform_device_count).  JAX_PLATFORMS
set by the caller wins, so the card tests run on a GPU machine with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`; whether a card is
present is decided inside the `gpu` fixture, never at import time.
Env vars must be set before jax is imported anywhere.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Persistent XLA compile cache: interpret-mode Pallas graphs take seconds to
# compile per geometry on CPU and dominate suite wall time; with the cache a
# re-run pays only trace time.  Repo-local and gitignored.
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(_REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, _REPO)

import numpy as np
import pytest

REPO_ROOT = _REPO
TESTDATA = os.path.join(REPO_ROOT, "testdata")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def testdata_dir():
    return TESTDATA


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (tests marked `gpu`)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX's platform is {jax.default_backend()!r}")
    return jax.devices()[0]
