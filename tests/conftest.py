"""Test configuration: CPU backend, float64, 8 virtual devices for mesh tests.

The reference runs everything in Float64 on CPU; correctness oracles here do
the same.  Multi-device sharding tests use an 8-device virtual CPU mesh via
``xla_force_host_platform_device_count``.  The GPU path is exercised here
through the Pallas interpreter; on the GPU itself, ``python chip_smoke.py``.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module: a full-suite run
    accumulates ~180 XLA:CPU executables and the large 8-virtual-device
    shard_map compile near the end then segfaults inside LLVM (reproducible
    at the same test, passes standalone).  Per-module clearing keeps
    within-module compile reuse."""
    yield
    jax.clear_caches()
