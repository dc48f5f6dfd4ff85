"""GPU-driven meshlet culling pipeline as masked compaction over flat
cluster arrays.

Parity with the reference's three-kernel pipeline (SURVEY.md §2.5
MeshletCuller):
- draw-list generation (draw_list_generator.comp:30-88): one
  {drawInstance, meshlet} pair per loaded cluster with the requested
  alpha mode; subgroup-ballot compaction -> stable argsort compaction
- draw-list culling (draw_list_culler.comp):
  - frustum: world-space sphere vs 6 camera planes (:68-77)
  - cone: meshoptimizer cone-cap test (:186-192)
  - occlusion: Mara-McGuire projected sphere AABB -> HiZ mip by pixel
    diameter, reverse-z min 2x2 gather, closest-depth compare (:109-183)
  - visible list + optionally the occluded list as second-phase input
- the dispatch-args writer becomes the list count (no indirect dispatch
  inside a jit; downstream ops mask by count)

Draw stats (drawn meshlet count) = mask sums, replacing the shader
atomics (forward.mesh:117-121).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _sd(plane, p):
    """dot(plane, vec4(p, 1)) (draw_list_culler.comp:57)."""
    return jnp.einsum("...i,...i->...", p, plane[..., :3]) + plane[..., 3]


def transform_cluster_bounds(static_scene: dict, frame: dict, uniform_scales):
    """Object-space meshlet bounds -> world space (transformBounds)."""
    inst = static_scene["wc_instance"]
    m = frame["transforms"][inst]  # (C, 3, 4)
    center = (
        jnp.einsum("cij,cj->ci", m[:, :, :3], static_scene["wc_sphere_center"])
        + m[:, :, 3]
    )
    scale = uniform_scales[inst]
    radius = jnp.abs(static_scene["wc_sphere_radius"] * scale)
    axis = jnp.einsum("cij,cj->ci", m[:, :, :3], static_scene["wc_cone_axis"])
    axis = axis / jnp.maximum(jnp.linalg.norm(axis, axis=-1, keepdims=True), 1e-20)
    return center, radius, axis, static_scene["wc_cone_cutoff"]


def sphere_outside_frustum(center, radius, frustum_planes):
    """(C,) true when fully outside any of the 6 planes."""
    d = jnp.stack([_sd(frustum_planes[i], center) for i in range(6)], axis=-1)
    return jnp.any(d < -radius[..., None], axis=-1)


def cone_cap_hidden(center, radius, axis, cutoff, eye):
    """meshoptimizer cone test (draw_list_culler.comp:186-192)."""
    to_c = center - eye
    dist = jnp.linalg.norm(to_c, axis=-1)
    return jnp.einsum("ci,ci->c", to_c, axis) >= cutoff * dist + radius


def project_sphere_view(c, r, znear, p00, p11):
    """Mara-McGuire projected sphere UV AABB (draw_list_culler.comp:79-105).

    c: view-space center with +z INTO the screen (caller negates z),
    returns (valid, aabb_uv (..., 4) minx miny maxx maxy in uv space)."""
    valid = c[..., 2] >= r + znear
    cz = jnp.where(valid, c[..., 2], 1.0)
    crx = c[..., 0] * r
    cry = c[..., 1] * r
    crz = cz * r
    czr2 = cz * cz - r * r

    vx = jnp.sqrt(jnp.maximum(c[..., 0] ** 2 + czr2, 0.0))
    minx = (vx * c[..., 0] - crz) / (vx * cz + crx)
    maxx = (vx * c[..., 0] + crz) / (vx * cz - crx)
    vy = jnp.sqrt(jnp.maximum(c[..., 1] ** 2 + czr2, 0.0))
    miny = (vy * c[..., 1] - crz) / (vy * cz + cry)
    maxy = (vy * c[..., 1] + crz) / (vy * cz - cry)

    # clip -> uv: aabb.xwzy * (.5,-.5,.5,-.5) + .5
    aabb = jnp.stack(
        [
            minx * p00 * 0.5 + 0.5,
            maxy * p11 * -0.5 + 0.5,
            maxx * p00 * 0.5 + 0.5,
            miny * p11 * -0.5 + 0.5,
        ],
        axis=-1,
    )
    return valid, aabb


def sphere_occluded(center, radius, cam: dict, hiz_mips: list, width: int, height: int):
    """HiZ occlusion test (isSphereOccluded)."""
    if not hiz_mips:
        return jnp.zeros(center.shape[:-1], bool)
    n_mips = len(hiz_mips)

    w2c = cam["world_to_camera"]
    c_view = center @ w2c[:3, :3].T + w2c[:3, 3]
    conservative_r = radius * cam["max_view_scale"]
    c_pos = jnp.stack([c_view[..., 0], c_view[..., 1], -c_view[..., 2]], -1)
    p00 = cam["camera_to_clip"][0, 0]
    p11 = cam["camera_to_clip"][1, 1]
    valid, aabb = project_sphere_view(c_pos, conservative_r, cam["near"], p00, p11)

    diag = (aabb[..., 2:4] - aabb[..., 0:2]) * jnp.array(
        [width, height], jnp.float32
    )
    px_diameter = jnp.linalg.norm(diag, axis=-1)
    mip = jnp.clip(
        jnp.floor(jnp.log2(jnp.maximum(px_diameter, 1e-6))).astype(jnp.int32),
        0,
        n_mips - 1,
    )

    # closest depth on the sphere toward the camera
    view_dir = cam["eye"] - center
    view_dir = view_dir / jnp.maximum(
        jnp.linalg.norm(view_dir, axis=-1, keepdims=True), 1e-20
    )
    closest_ws = center + view_dir * radius[..., None]
    w2clip = cam["camera_to_clip"] @ cam["world_to_camera"]
    ph = jnp.concatenate([closest_ws, jnp.ones_like(closest_ws[..., :1])], -1)
    clip = ph @ w2clip.T
    closest_depth = clip[..., 2] / clip[..., 3]

    # center uv (with pow2 HiZ, uv scale is 1: hiz dims are the rounded
    # size and we pad the depth to match in ops/hiz.py)
    cph = jnp.concatenate([center, jnp.ones_like(center[..., :1])], -1)
    cclip = cph @ w2clip.T
    uv = (cclip[..., :2] / cclip[..., 3:4]) * 0.5 + 0.5
    from .hiz import hiz_dimensions

    hw, hh = hiz_dimensions(width, height)
    uv = uv * jnp.array(
        [width / (hw * 2), height / (hh * 2)], jnp.float32
    )  # hizUvScale

    # 2x2 min gather at each cluster's mip, via per-mip where-select
    occluded = jnp.zeros(center.shape[:-1], bool)
    for m, hz in enumerate(hiz_mips):
        mh, mw = hz.shape
        t = uv * jnp.array([mw, mh], jnp.float32) - 0.5
        t0 = jnp.floor(t)
        x0 = t0[..., 0].astype(jnp.int32)
        y0 = t0[..., 1].astype(jnp.int32)

        def fetch(yi, xi):
            inside = (yi >= 0) & (yi < mh) & (xi >= 0) & (xi < mw)
            yi = jnp.clip(yi, 0, mh - 1)
            xi = jnp.clip(xi, 0, mw - 1)
            # border 1 (near) so out-of-bounds never culls
            return jnp.where(inside, hz[yi, xi], 1.0)

        hiz_depth = jnp.minimum(
            jnp.minimum(fetch(y0, x0), fetch(y0, x0 + 1)),
            jnp.minimum(fetch(y0 + 1, x0), fetch(y0 + 1, x0 + 1)),
        )
        occluded = jnp.where(mip == m, closest_depth < hiz_depth, occluded)

    return valid & occluded


def cull_clusters(
    static_scene: dict,
    frame: dict,
    cam: dict,
    uniform_scales: jnp.ndarray,
    hiz_mips: list,
    width: int,
    height: int,
    output_second_phase: bool = False,
):
    """Full first/second-phase cluster cull.

    Returns dict: visible (C,) bool mask, visible_list (C,) i32 compacted
    indices, visible_count, second_phase (C,) bool, and draw stats.
    """
    center, radius, axis, cutoff = transform_cluster_bounds(
        static_scene, frame, uniform_scales
    )
    inst = static_scene["wc_instance"]
    scale_ok = uniform_scales[inst] != 0.0

    outside = sphere_outside_frustum(center, radius, cam["frustum_planes"])
    cone_hidden = cone_cap_hidden(center, radius, axis, cutoff, cam["eye"])
    visible = ~outside & ~cone_hidden
    occluded = jnp.where(
        visible, sphere_occluded(center, radius, cam, hiz_mips, width, height), False
    )
    visible = visible & ~occluded
    # zero-scale instances draw unconditionally (reference: skip tests)
    visible = visible | ~scale_ok

    order = jnp.argsort(~visible, stable=True)
    count = visible.sum().astype(jnp.int32)
    result = {
        "visible": visible,
        "visible_list": order.astype(jnp.int32),
        "visible_count": count,
        "drawn_meshlets": count,
        "rasterized_triangles": jnp.sum(
            jnp.where(visible, static_scene["wc_tri_count"], 0)
        ),
    }
    if output_second_phase:
        second = occluded & scale_ok
        result["second_phase"] = second
        result["second_phase_list"] = jnp.argsort(~second, stable=True).astype(
            jnp.int32
        )
        result["second_phase_count"] = second.sum().astype(jnp.int32)
    return result
