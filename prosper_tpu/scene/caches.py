"""On-disk asset caches: processed meshes and texture arenas.

The reference keeps three versioned caches (SURVEY.md §5
checkpoint/resume): SPIR-V shader cache keyed by source hash
(Device.cpp:1715-1806), mesh cache v4 with optimized+meshletized blobs
(DeferredLoadingContext.cpp:492-660), and BC7 texture cache v5 with
mtime tags (Texture.cpp:78-165). Equivalents here:
- compile cache: JAX persistent compilation cache (enable_compile_cache)
- mesh cache: clustered+packed MeshData blobs in npz, keyed by
  (source path, primitive, mtime, version); version mismatch or stale
  mtime regenerates, like cacheValid
- texture cache: quad-packed mip chains in npz keyed the same way

Cache directory mirrors the reference's `prosper_cache/` sibling dir.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

MESH_CACHE_VERSION = 4  # v4: binned-SAH triangle clustering (was Morton)
TEXTURE_CACHE_VERSION = 1


_CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def cache_dir(scene_path: str) -> str:
    """`prosper_cache/` next to the scene like the reference; falls back
    to generated/prosper_cache/ in the checkout when the scene directory
    is read-only."""
    d = os.path.join(os.path.dirname(os.path.abspath(scene_path)), "prosper_cache")
    try:
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(d, ".w")
        with open(probe, "w"):
            pass
        os.remove(probe)
        return d
    except OSError:
        d = os.path.join(_CHECKOUT, "generated", "prosper_cache")
        os.makedirs(d, exist_ok=True)
        return d


def compile_cache_dir() -> str:
    """Where XLA's persistent compilation cache lives: the directory
    JAX_COMPILATION_CACHE_DIR names when it is set, else the fixed
    `<checkout>/.jax_cache` (a fixed path, so entries are found again)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """XLA persistent compilation cache = the shader-cache analog.
    Returns the directory in use."""
    import jax

    directory = compile_cache_dir()
    os.makedirs(directory, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", directory)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return directory


def _key(*parts) -> str:
    h = hashlib.sha1()
    for p in parts:
        h.update(str(p).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def _mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def mesh_cache_path(scene_path: str, mesh_index: int, prim_index: int) -> str:
    key = _key(
        "mesh",
        MESH_CACHE_VERSION,
        os.path.abspath(scene_path),
        _mtime(scene_path),
        mesh_index,
        prim_index,
    )
    return os.path.join(cache_dir(scene_path), f"mesh_{key}.npz")


def save_mesh_cache(path: str, arrays: dict) -> None:
    np.savez(path, __version__=MESH_CACHE_VERSION, **arrays)


def load_mesh_cache(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["__version__"]) != MESH_CACHE_VERSION:
                return None  # version mismatch -> regenerate
            return {k: z[k] for k in z.files if k != "__version__"}
    except Exception:
        return None


def texture_cache_path(scene_path: str, image_uri: str, max_dim) -> str:
    src = os.path.join(os.path.dirname(os.path.abspath(scene_path)), image_uri)
    key = _key(
        "tex", TEXTURE_CACHE_VERSION, os.path.abspath(src), _mtime(src), max_dim
    )
    return os.path.join(cache_dir(scene_path), f"tex_{key}.npz")


def save_texture_cache(path: str, mips: list[np.ndarray], srgb: bool) -> None:
    np.savez(
        path,
        __version__=TEXTURE_CACHE_VERSION,
        __srgb__=int(srgb),
        n=len(mips),
        **{f"mip{i}": m for i, m in enumerate(mips)},
    )


def load_texture_cache(path: str) -> tuple[list[np.ndarray], bool] | None:
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["__version__"]) != TEXTURE_CACHE_VERSION:
                return None
            mips = [z[f"mip{i}"] for i in range(int(z["n"]))]
            return mips, bool(int(z["__srgb__"]))
    except Exception:
        return None
