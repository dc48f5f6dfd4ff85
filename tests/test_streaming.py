"""Asset streaming + caches: deferred loading must converge to the same
arenas as synchronous loading; caches must round-trip."""

import os
import time

import numpy as np

from prosper_tpu.scene.world import World
from prosper_tpu.testing import seeded_scene_path


def _scene():
    return seeded_scene_path("small")


def test_streaming_converges_to_full_load():
    full = World(_scene(), use_cache=False)
    stream = World(_scene(), use_cache=False, streaming=True)

    # before streaming starts: nothing visible (meshletCount==0 gate)
    assert (stream.wc_tri_count == 0).all()
    assert np.count_nonzero(stream.wt_p0) == 0

    stream.start_streaming()
    adopted_total = 0
    deadline = time.time() + 120
    while not stream.streaming_done and time.time() < deadline:
        adopted_total += stream.poll_streaming(budget=2)
        time.sleep(0.01)
    adopted_total += stream.poll_streaming(budget=1000)
    assert stream.streaming_done
    assert stream.streaming_dirty
    assert adopted_total == len(full.meshes)

    np.testing.assert_array_equal(stream.wc_tri_count, full.wc_tri_count)
    np.testing.assert_allclose(stream.wt_p0, full.wt_p0)
    np.testing.assert_allclose(stream.a_packed, full.a_packed)
    np.testing.assert_allclose(stream.wc_sphere_radius, full.wc_sphere_radius)


def test_mesh_cache_roundtrip(tmp_path):
    import shutil

    from prosper_tpu.scene import caches

    # copy a scene stub so the cache lands in tmp
    scene_dir = tmp_path / "scene"
    shutil.copytree(
        os.path.dirname(_scene()),
        scene_dir,
        ignore=shutil.ignore_patterns("*.png", "prosper_cache"),
    )
    spath = str(scene_dir / "scene.gltf")

    w1 = World(spath, use_cache=True)
    t0 = time.time()
    w2 = World(spath, use_cache=True)
    cached_time = time.time() - t0
    np.testing.assert_allclose(w1.wt_p0, w2.wt_p0)
    np.testing.assert_allclose(w1.a_packed, w2.a_packed)
    assert (scene_dir / "prosper_cache").exists()
    # cache hit should be clearly faster than the cold path typically is,
    # but we only assert correctness + existence to stay robust
    assert cached_time >= 0


def test_texture_cache_roundtrip(tmp_path):
    import shutil

    from prosper_tpu.scene.textures import build_texture_arena
    from prosper_tpu.scene.world import World

    scene_dir = tmp_path / "scene"
    shutil.copytree(
        os.path.dirname(_scene()), scene_dir,
        ignore=shutil.ignore_patterns("prosper_cache"),
    )
    spath = str(scene_dir / "scene.gltf")
    w = World(spath, use_cache=False)
    a1 = build_texture_arena(w.doc, max_dim=256, scene_path=spath)
    a2 = build_texture_arena(w.doc, max_dim=256, scene_path=spath)  # cache hit
    np.testing.assert_array_equal(a1.data, a2.data)
    np.testing.assert_array_equal(a1.table, a2.table)
    caches = list((scene_dir / "prosper_cache").glob("tex_*.npz"))
    assert caches, "texture cache files written"


def test_texture_streaming_converges_to_full_arena():
    """build_streaming_arena: identical layout to the upfront arena,
    neutral contents that converge to the full arena after adoption
    (DeferredLoadingContext::loadNextTexture analog)."""
    from prosper_tpu.scene.gltf import load_gltf
    from prosper_tpu.scene.textures import (
        build_streaming_arena,
        build_texture_arena,
    )
    from prosper_tpu.scene.streaming import LoadedTexture

    doc = load_gltf(_scene())
    full = build_texture_arena(doc, max_dim=256)
    streamed, jobs = build_streaming_arena(doc, max_dim=256)

    # layout (offsets/dims/flags/mip counts) must match the upfront build
    np.testing.assert_array_equal(streamed.table, full.table)
    np.testing.assert_array_equal(streamed.n_mips, full.n_mips)
    assert streamed.data.shape == full.data.shape
    assert len(jobs) == len(doc.images)

    # contents start neutral and converge to the full arena
    data = streamed.data.copy()
    for job in jobs:
        tex = job()
        assert isinstance(tex, LoadedTexture)
        data[tex.offset : tex.offset + len(tex.chunk)] = tex.chunk
    np.testing.assert_array_equal(data, full.data)


def test_world_streams_textures_after_meshes():
    from prosper_tpu.scene.streaming import LoadedTexture
    from prosper_tpu.scene.textures import build_streaming_arena

    stream = World(_scene(), use_cache=False, streaming=True)
    _, jobs = build_streaming_arena(stream.doc, max_dim=64)
    stream.start_streaming(jobs)
    textures = []
    deadline = time.time() + 120
    while not stream.streaming_done and time.time() < deadline:
        stream.poll_streaming(budget=4)
        textures += stream.take_adopted_textures()
        time.sleep(0.01)
    stream.poll_streaming(budget=1000)
    textures += stream.take_adopted_textures()
    assert stream.streaming_done
    assert len(textures) == len(jobs)
    assert all(isinstance(t, LoadedTexture) for t in textures)
