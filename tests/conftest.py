"""Test config: run all tests on a virtual 8-device CPU mesh so sharding
paths are exercised without a multi-device host, with the persistent
compilation cache where scene/caches.compile_cache_dir puts it.

Tests that need an NVIDIA GPU carry the `gpu` marker and skip here; run
them on a GPU host with `python -m pytest tests/ -m gpu`.
"""

import jax
import pytest

from prosper_tpu.scene.caches import compile_cache_dir


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere)"
    )
    markexpr = config.option.markexpr or ""
    if not ("gpu" in markexpr and "not gpu" not in markexpr):
        # everything but an explicit `-m gpu` run stays on the CPU
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", False)
    # as at every entry point of the program: no TF32 on a GPU
    jax.config.update("jax_default_matmul_precision", "highest")
    # Per-op eager dispatch is slow on the CPU; the persistent cache
    # makes repeat test runs cheap.
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


@pytest.fixture
def gpu_backend():
    """Skip unless JAX can reach a GPU. Decided inside the fixture (never
    at import or collection time) so every test worker collects the same
    tests."""
    try:
        jax.devices("gpu")
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU")
