"""Test harness: force the local CPU backend.

Multi-device sharding tests need the XLA device-count flag before jaxlib
loads, so they spawn their own subprocess with a clean environment — see
tests/test_sharding.py and ``clean_jax_env`` below.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from ice_halo_sim_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: drops warm test runs to ~ms/op.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

CLEAN_ENV_DOC = "see tests/conftest.py for the subprocess-with-clean-env pattern"


def clean_jax_env(n_devices: int = 8) -> dict:
    """Environment for a subprocess with N virtual CPU devices."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "").replace("--xla_force_host_platform_device_count=8", "")
        + f" --xla_force_host_platform_device_count={n_devices}"
    ).strip()
    return env


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
