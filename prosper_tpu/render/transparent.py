"""Transparent-geometry forward pass.

Analog of ForwardRenderer::recordTransparent in the reference frame graph
(/root/reference/src/render/Renderer.cpp:494-500,
src/render/ForwardRenderer.cpp): blend-mode meshes draw after opaque
shading + skybox with alpha blending and NO sorting. Here the same
primary rays are traced against only the blend-material clusters
(a per-cluster trace mask, the draw-list alphaMode filter of
draw_list_generator.comp:53-60) and alpha-blends the nearest transparent
surface over the opaque result — a single unsorted layer, matching the
reference's unsorted meshlet raster in the common case.

Shading matches forward.frag: directional + clustered lights (+ IBL when
enabled) via the same BRDF as the opaque path.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops import trace
from ..ops.rays import pinhole_rays
from .shading import eval_directional_light


def blend_cluster_mask(static_scene: dict) -> jnp.ndarray:
    """(C,) bool: clusters whose material alphaMode == 2 (Blend)."""
    alpha_mode = static_scene["materials"]["alpha_mode"]
    return alpha_mode[static_scene["wc_material"]] == 2


def transparent_pass(
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    hdr: jnp.ndarray,  # (H, W, 3) shaded opaque + background
    opaque_z_cam: jnp.ndarray,  # (R,) view-space z of the opaque surface
    width: int,
    height: int,
    ibl_data: dict | None = None,
) -> jnp.ndarray:
    """Alpha-blend the nearest blend-material surface over `hdr`."""
    px = jnp.tile(jnp.arange(width, dtype=jnp.int32), height)
    py = jnp.repeat(jnp.arange(height, dtype=jnp.int32), width)
    uv = (jnp.stack([px, py], -1).astype(jnp.float32) + 0.5) / jnp.array(
        [width, height], jnp.float32
    )
    jit = cam["current_jitter"]
    o, d = pinhole_rays(cam, uv + jit * jnp.array([0.5, -0.5]))

    from .surface import evaluate_surface, pixel_cone_alpha

    cone = {"alpha": pixel_cone_alpha(cam, height), "bias": 0.0}
    # trace against the blend clusters only (the draw list's alphaMode
    # filter)
    tracer = trace.make_tracer(static_scene, frame)
    hit = tracer.closest(
        o, d, 1e-4, jnp.inf, blend_cluster_mask(static_scene)
    )

    surface = evaluate_surface(
        static_scene, frame, arena, o, d, hit, cone=cone
    )

    w2c = cam["world_to_camera"]
    z_cam_t = surface["position_ws"] @ w2c[2, :3] + w2c[2, 3]
    valid = (hit["tri"] >= 0) & (z_cam_t > opaque_z_cam)  # nearer (view -z)

    lights = frame["lights"]
    color = eval_directional_light(surface, lights)
    from ..ops.clustering import build_light_clusters, eval_clustered_lights

    clusters = build_light_clusters(cam, lights, width, height)
    color = color + eval_clustered_lights(
        surface, lights, clusters, px, py, z_cam_t, cam["near"], cam["far"]
    )
    if ibl_data is not None:
        from ..ops.ibl import eval_ibl

        color = color + eval_ibl(surface, ibl_data)

    a = jnp.clip(surface["alpha"], 0.0, 1.0)
    blend = jnp.where(valid, a, 0.0)[..., None].reshape(height, width, 1)
    # miss-ray surfaces carry non-finite garbage; mask before the blend
    # arithmetic (0 * NaN would poison untouched pixels)
    color = jnp.where(valid[..., None], color, 0.0).reshape(height, width, 3)
    return hdr * (1.0 - blend) + color * blend
