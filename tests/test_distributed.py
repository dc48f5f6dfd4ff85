"""Multi-device pixel-band sharding on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from prosper_tpu.render.distributed import (
    make_mesh,
    pt_render_sharded,
    replicate_to_mesh,
)
from prosper_tpu.render.pt import pt_render_sample
from prosper_tpu.testing import make_test_scene


def _dev(tree):
    return {
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in tree.items()
    }


def test_sharded_matches_single_device():
    assert len(jax.devices()) >= 8
    static, frame, arena, cam_fn = make_test_scene(4)
    static, frame, arena = _dev(static), _dev(frame), _dev(arena)
    W, H = 64, 32
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}

    single = pt_render_sample(
        static, frame, arena, cam, W, H, 0, max_bounces=2
    )

    mesh = make_mesh(8)
    color, total_rays = pt_render_sharded(
        mesh,
        replicate_to_mesh(static, mesh),
        replicate_to_mesh(frame, mesh),
        replicate_to_mesh(arena, mesh),
        replicate_to_mesh(cam, mesh),
        W,
        H,
        0,
        max_bounces=2,
    )
    assert int(total_rays) > 0
    # both trace the same pixels with the same RNG streams (pcg state is
    # (px, py, frame)), in bands or whole -> identical radiance
    np.testing.assert_allclose(
        np.asarray(color), np.asarray(single), rtol=1e-5, atol=1e-6
    )


def test_restir_sharded_matches_single_device():
    """Sharded ReSTIR (pixel bands + ppermute halo exchange for spatial
    reuse) must match the single-device pipeline: per-pixel RNG streams
    are absolute-coordinate seeded and the halo supplies exactly the
    neighbor rows spatial reuse can reach."""
    import numpy as np

    from prosper_tpu.render.distributed import (
        make_mesh,
        restir_render_sharded,
    )
    from prosper_tpu.render.restir import render_restir
    from prosper_tpu.testing import make_test_scene

    W = H = 256  # bands of 32 rows >= the 30 px spatial radius
    static, frame, arena, cam_fn = make_test_scene(n_boxes=6)
    import jax.numpy as jnp

    static = {
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in static.items()
    }
    frame_d = {
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in frame.items()
        if k not in ("scene_camera", "bvh_depth")
    }
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}
    from prosper_tpu.ops.texture import pack_material_tables

    arena_d = {k: jnp.asarray(v) for k, v in arena.items()}
    lut = jnp.zeros((48, 48, 48, 3), jnp.float32)

    _img, single = render_restir(
        static, frame_d, arena_d, cam, lut, W, H, 5
    )
    mesh = make_mesh(8)
    sharded = restir_render_sharded(
        mesh, static, frame_d, arena_d, cam, W, H, 5
    )
    a = np.asarray(single)
    b = np.asarray(sharded)
    assert np.isfinite(b).all()
    assert np.allclose(a, b, atol=1e-5), float(np.abs(a - b).max())


def test_deferred_sharded_matches_single_device():
    """Sharded deferred core (band G-buffer + clustered shading with
    absolute froxel coordinates) must match the single-device path."""
    import numpy as np
    import jax.numpy as jnp

    from prosper_tpu.ops.clustering import build_light_clusters
    from prosper_tpu.render.deferred import shade_deferred
    from prosper_tpu.render.distributed import (
        deferred_render_sharded,
        make_mesh,
    )
    from prosper_tpu.render.gbuffer import render_gbuffer
    from prosper_tpu.testing import make_test_scene

    W = H = 256  # 32-row bands align to the froxel tile
    static, frame, arena, cam_fn = make_test_scene(n_boxes=6)
    static = {
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in static.items()
    }
    frame_d = {
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in frame.items()
        if k not in ("scene_camera", "bvh_depth")
    }
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}
    arena_d = {k: jnp.asarray(v) for k, v in arena.items()}

    gbuf = render_gbuffer(static, frame_d, arena_d, cam, W, H)
    clusters = build_light_clusters(cam, frame_d["lights"], W, H)
    single = shade_deferred(
        gbuf, clusters, frame_d["lights"], cam, W, H
    )
    mesh = make_mesh(8)
    sharded = deferred_render_sharded(
        mesh, static, frame_d, arena_d, cam, W, H
    )
    a = np.asarray(single)
    b = np.asarray(sharded)
    assert np.isfinite(b).all()
    assert np.allclose(a, b, atol=1e-5), float(np.abs(a - b).max())


def test_deferred_sharded_unaligned_height():
    """1080p-class band alignment: heights that do
    NOT split into 32-aligned bands (1080/8 = 135 rows) must shard by
    padding bands to the froxel tile and cropping — band results equal
    the single-device path."""
    import numpy as np
    import jax.numpy as jnp

    from prosper_tpu.ops.clustering import build_light_clusters
    from prosper_tpu.render.deferred import shade_deferred
    from prosper_tpu.render.distributed import (
        deferred_render_sharded,
        make_mesh,
    )
    from prosper_tpu.render.gbuffer import render_gbuffer
    from prosper_tpu.testing import make_test_scene

    W, H = 64, 136  # 136/8 = 17-row bands: neither 32-aligned nor tiled
    static, frame, arena, cam_fn = make_test_scene(n_boxes=6)
    dev = lambda t: {  # noqa: E731
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in t.items()
    }
    static = dev(static)
    frame_d = {
        k: v
        for k, v in dev(frame).items()
        if k not in ("scene_camera", "bvh_depth")
    }
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}
    arena_d = {k: jnp.asarray(v) for k, v in arena.items()}

    gbuf = render_gbuffer(static, frame_d, arena_d, cam, W, H)
    clusters = build_light_clusters(cam, frame_d["lights"], W, H)
    single = shade_deferred(gbuf, clusters, frame_d["lights"], cam, W, H)
    mesh = make_mesh(8)
    sharded = deferred_render_sharded(
        mesh, static, frame_d, arena_d, cam, W, H
    )
    a = np.asarray(single)
    b = np.asarray(sharded)
    assert b.shape == a.shape
    assert np.isfinite(b).all()
    assert np.allclose(a, b, atol=1e-5), float(np.abs(a - b).max())


def test_restir_sharded_unaligned_height():
    """ReSTIR band sharding with height not divisible by the mesh."""
    import numpy as np
    import jax.numpy as jnp

    from prosper_tpu.render.distributed import (
        make_mesh,
        restir_render_sharded,
    )
    from prosper_tpu.render.restir import render_restir
    from prosper_tpu.testing import make_test_scene

    W, H = 64, 152  # 152/8 = 19-row bands (no froxels in restir_shade,
    # but the halo exchange must handle padded final-band rows)
    static, frame, arena, cam_fn = make_test_scene(n_boxes=6)
    dev = lambda t: {  # noqa: E731
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in t.items()
    }
    static = dev(static)
    frame_d = {
        k: v
        for k, v in dev(frame).items()
        if k not in ("scene_camera", "bvh_depth")
    }
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}
    arena_d = {k: jnp.asarray(v) for k, v in arena.items()}
    lut = jnp.zeros((48, 48, 48, 3), jnp.float32)

    _img, single = render_restir(
        static, frame_d, arena_d, cam, lut, W, H, 5
    )
    mesh = make_mesh(8)
    sharded = restir_render_sharded(
        mesh, static, frame_d, arena_d, cam, W, H, 5
    )
    a = np.asarray(single)
    b = np.asarray(sharded)
    assert b.shape == a.shape
    assert np.isfinite(b).all()
    assert np.allclose(a, b, atol=1e-5), float(np.abs(a - b).max())


def test_restir_sharded_textured_scene_matches_single_device():
    """On a textured scene each band must pick the single-device texture
    mips: the ray-cone footprint is set by the full frame's height, not
    the band's."""
    from prosper_tpu import parity
    from prosper_tpu.render.distributed import restir_render_sharded
    from prosper_tpu.render.restir import render_restir

    W, H = 64, 128
    sc = parity.load_scene("small", W, H, max_texture_dim=64)
    args = (sc["static"], sc["frame"], sc["arena"], sc["cam"])
    _img, single = render_restir(*args, sc["lut"], W, H, 0)
    sharded = restir_render_sharded(make_mesh(4), *args, W, H, 0)
    a, b = np.asarray(single), np.asarray(sharded)
    assert np.allclose(a, b, atol=1e-4), float(np.abs(a - b).max())
