"""Compile-cache placement (scene/caches.py): the directory
JAX_COMPILATION_CACHE_DIR names, else <checkout>/.jax_cache."""

import os

import jax

from prosper_tpu.scene import caches

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert caches.enable_compile_cache() == str(tmp_path / "xla")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "xla")
        assert os.path.isdir(tmp_path / "xla")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert caches.compile_cache_dir() == os.path.join(CHECKOUT, ".jax_cache")


def test_asset_cache_fallback_stays_in_checkout(tmp_path):
    ro = tmp_path / "ro"
    ro.mkdir()
    (ro / "prosper_cache").write_text("not a directory")
    d = caches.cache_dir(str(ro / "scene.gltf"))
    assert d.startswith(CHECKOUT)
