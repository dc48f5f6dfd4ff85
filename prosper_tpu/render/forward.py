"""Forward path: primary-visibility ray cast + full unshadowed light
evaluation (the deferred/forward raster analog, BASELINE config 1).

The reference rasterises meshlets and shades in forward.frag with
clustered lights; primary visibility here is produced by ray casting the
same cluster scene (SURVEY.md §7: no software rasterizer), then
shading matches forward.frag's math: directional + all point + all spot lights, unshadowed, optional IBL.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import trace
from ..ops.rays import pinhole_rays
from ..ops.tonemap import tone_map
from .shading import (
    eval_directional_light,
    point_light_irradiance,
    spot_light_irradiance,
)
from .surface import evaluate_surface
from ..ops.brdf import eval_brdf_times_nol


def eval_all_lights(surface: dict, lights: dict) -> jnp.ndarray:
    """Directional + every point/spot light, unshadowed (forward.frag core).
    Reference implementation (O(pixels x lights)); the frame path uses the
    clustered froxel lists (forward.frag itself is clustered), which is
    equal because the radial falloff is zero beyond each light's radius
    and froxel inclusion is conservative (tests/test_frame_graph.py)."""
    color = eval_directional_light(surface, lights)

    n_point = lights["point_position"].shape[0]
    n_spot = lights["spot_position"].shape[0]
    pos = surface["position_ws"]

    def add_point(i, acc):
        l, _, irr = point_light_irradiance(lights, i, pos)
        contrib = irr * eval_brdf_times_nol(
            l,
            surface["inv_view_ray"],
            surface["normal_ws"],
            surface["albedo"],
            surface["roughness"],
            surface["metallic"],
        )
        return acc + jnp.where(i < lights["point_count"], contrib, 0.0)

    def add_spot(i, acc):
        l, _, irr = spot_light_irradiance(lights, i, pos)
        contrib = irr * eval_brdf_times_nol(
            l,
            surface["inv_view_ray"],
            surface["normal_ws"],
            surface["albedo"],
            surface["roughness"],
            surface["metallic"],
        )
        return acc + jnp.where(i < lights["spot_count"], contrib, 0.0)

    color = jax.lax.fori_loop(
        0, jnp.minimum(lights["point_count"], n_point), add_point, color
    )
    color = jax.lax.fori_loop(
        0, jnp.minimum(lights["spot_count"], n_spot), add_spot, color
    )
    return color


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "draw_type", "use_transparent", "alpha_rounds",
        "aniso_taps", "return_hdr",
    ),
)
def render_forward(
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    lut: jnp.ndarray,
    width: int,
    height: int,
    exposure: float = 1.0,
    contrast: float = 1.0,
    draw_type: int = 0,
    use_transparent: bool = False,
    alpha_rounds: int = 0,
    aniso_taps: int = 1,
    return_hdr: bool = False,
):
    """One forward frame -> (H, W, 3) display-encoded image (and the
    linear HDR frame when return_hdr)."""
    # row-major pixel-center rays (no jitter for the still-frame golden)
    uv = jnp.stack(
        [
            (jnp.tile(jnp.arange(width, dtype=jnp.float32), height) + 0.5)
            / width,
            (jnp.repeat(jnp.arange(height, dtype=jnp.float32), width) + 0.5)
            / height,
        ],
        axis=-1,
    )
    o, d = pinhole_rays(cam, uv)

    tracer = trace.make_tracer(static_scene, frame)
    # opaque pass excludes blend-material clusters (the draw list's
    # alphaMode filter, draw_list_generator.comp:53-60)
    opaque = None
    if use_transparent:
        from .transparent import blend_cluster_mask

        opaque = ~blend_cluster_mask(static_scene)

    def closest_fn(o_, d_, t_min, t_max):
        return tracer.closest(o_, d_, t_min, t_max, opaque)

    hit = closest_fn(o, d, 1e-4, jnp.inf)
    if alpha_rounds and "mat_i32" in arena:
        # alpha-mask discard (forward.frag:56-58)
        from .gbuffer import mask_discard_retrace

        hit = mask_discard_retrace(
            arena, static_scene, closest_fn, o, d, hit, alpha_rounds
        )
    from .surface import pixel_cone_alpha

    cone = {
        "alpha": pixel_cone_alpha(cam, height),
        "bias": 0.0,
        "aniso_taps": aniso_taps,
    }
    surface = evaluate_surface(
        static_scene, frame, arena, o, d, hit, cone=cone
    )
    if draw_type != 0:
        # debug AOV path (commonDebugDraw): raw values, no tone map
        from .debug import DrawType, debug_color

        dbg = debug_color(DrawType(draw_type), surface, hit, static_scene)
        dbg = jnp.where(surface["valid"][..., None], dbg, 0.0)
        dbg = jnp.clip(dbg.reshape(height, width, 3), 0.0, 1.0)
        return (dbg, dbg) if return_hdr else dbg
    # clustered direct lighting (forward.frag's clustered loop): the
    # froxel light lists shared with deferred shading
    lights = frame["lights"]
    color = eval_directional_light(surface, lights)
    if int(lights["point_position"].shape[0]) or int(
        lights["spot_position"].shape[0]
    ):
        w2c = cam["world_to_camera"]
        z_cam = jnp.where(
            surface["valid"],
            surface["position_ws"] @ w2c[2, :3] + w2c[2, 3],
            -jnp.inf,
        )
        from ..ops.clustering import (
            build_light_clusters, eval_clustered_lights,
        )

        clusters = build_light_clusters(cam, lights, width, height)
        px = jnp.tile(jnp.arange(width, dtype=jnp.int32), height)
        py = jnp.repeat(jnp.arange(height, dtype=jnp.int32), width)
        color = color + eval_clustered_lights(
            surface, lights, clusters, px, py, z_cam,
            cam["near"], cam["far"],
        )
    color = jnp.where(surface["valid"][..., None], color, 0.0)
    hdr = color.reshape(height, width, 3)
    if use_transparent:
        # recordTransparent slot after opaque (Renderer.cpp:494-500)
        from .transparent import transparent_pass

        w2c = cam["world_to_camera"]
        z_cam = jnp.where(
            surface["valid"],
            surface["position_ws"] @ w2c[2, :3] + w2c[2, 3],
            -jnp.inf,
        )
        hdr = transparent_pass(
            static_scene, frame, arena, cam, hdr, z_cam, width, height
        )
    img = tone_map(hdr, lut, exposure, contrast)
    return (img, hdr) if return_hdr else img
