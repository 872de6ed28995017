"""Test config: run everything on a virtual 8-device CPU mesh.

Set before any jax import — the JAX analogue of the reference's
CPU-MirroredStrategy fallback (SURVEY.md §4 "Distributed testing").
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

# Pin the cpu backend so tests always see the 8-device virtual mesh, and keep
# tests hermetic: the CLIs point the persistent compilation cache into the
# checkout (core/compile_cache.py), which tests must neither read nor fill.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual devices, got {len(devs)}"
    return devs
