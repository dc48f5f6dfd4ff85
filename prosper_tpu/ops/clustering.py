"""Clustered (froxel) light binning + clustered light evaluation.

Parity with /root/reference/res/shader/light_clustering.comp and
scene/light_clusters.glsl:
- 32 px tiles x 17 z-slices (LightClustering.hpp:25-26)
- Doom-2016 logarithmic slice mapping over [near, far]
- Intel-style tile frusta from the projection diagonal; sphere-vs-frustum
  point tests in view space; spot lights pass-through (the reference's
  isSpotVisible is `return true` — a faithful quirk)
- <=128 point + 128 spot indices per froxel

Data-parallel shape: instead of shared-memory atomics appending per-cluster
lists, the visibility mask is computed densely as (FX*FY*FZ, L) and
compacted per froxel with a stable argsort — same observable lists
(ascending light index order, matching the single-thread-order the
reference produces per its thread partitioning).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..render.shading import point_light_irradiance, spot_light_irradiance
from ..ops.brdf import eval_brdf_times_nol

LIGHT_CLUSTER_DIMENSION = 32
Z_SLICE_COUNT = 17
MAX_POINT_INDICES = 128
MAX_SPOT_INDICES = 128


def slice_starts(near, far):
    """sliceStart for each slice boundary (light_clusters.glsl:28-33)."""
    frac = jnp.arange(Z_SLICE_COUNT + 1, dtype=jnp.float32) / Z_SLICE_COUNT
    return near * jnp.power(far / near, frac)


def cluster_grid_size(width: int, height: int) -> tuple[int, int]:
    fx = -(-width // LIGHT_CLUSTER_DIMENSION)
    fy = -(-height // LIGHT_CLUSTER_DIMENSION)
    return fx, fy


@partial(jax.jit, static_argnames=("width", "height"))
def build_light_clusters(cam: dict, lights: dict, width: int, height: int):
    """Returns dict with per-froxel point light lists/counts.

    point_lists: (FX, FY, FZ, 128) i32; point_counts: (FX, FY, FZ) i32.
    Spot lights are all-visible per the reference quirk, so only a count
    is stored (the list is the identity prefix).
    """
    fx, fy = cluster_grid_size(width, height)
    fz = Z_SLICE_COUNT

    c2c = cam["camera_to_clip"]
    w2c = cam["world_to_camera"]
    near = cam["near"]
    far = cam["far"]

    # tile frusta side planes (light_clustering.comp:67-99)
    tile_scale = (
        jnp.array([width, height], jnp.float32) / (2.0 * LIGHT_CLUSTER_DIMENSION)
    )
    cx = jnp.arange(fx, dtype=jnp.float32)
    cy = jnp.arange(fy, dtype=jnp.float32)
    bias_x = tile_scale[0] - cx  # (FX,)
    bias_y = tile_scale[1] - cy  # (FY,)

    m00 = c2c[0, 0] * tile_scale[0]
    m11 = c2c[1, 1] * tile_scale[1]

    def norm_plane(p):
        return p / jnp.linalg.norm(p[..., :3], axis=-1, keepdims=True)

    zeros_x = jnp.zeros_like(bias_x)
    c1 = jnp.stack([jnp.full_like(bias_x, m00), zeros_x, -bias_x, zeros_x], -1)
    zeros_y = jnp.zeros_like(bias_y)
    c2 = jnp.stack([zeros_y, jnp.full_like(bias_y, m11), -bias_y, zeros_y], -1)
    c4 = jnp.array([0.0, 0.0, -1.0, 0.0])

    plane_xm = norm_plane(c4[None] - c1)  # (FX, 4)
    plane_xp = norm_plane(c4[None] + c1)
    plane_ym = norm_plane(c4[None] - c2)  # (FY, 4)
    plane_yp = norm_plane(c4[None] + c2)

    starts = slice_starts(near, far)  # (FZ+1,)
    near_d = jnp.where(
        jnp.arange(fz) == 0, 0.0, starts[: fz]
    )  # slice 0 near plane at 0
    far_d = starts[1 : fz + 1]

    # point light spheres in view space
    pos_vs = lights["point_position"] @ w2c[:3, :3].T + w2c[:3, 3]
    r = lights["point_radius"]
    l_count = lights["point_count"]
    n_l = pos_vs.shape[0]

    # signedDistance(plane, p) = dot(plane.xyz, p) - plane.w
    # side-plane signed distances, (L, FX)/(L, FY)
    sxm = pos_vs @ plane_xm[:, :3].T - plane_xm[None, :, 3]  # (L, FX)
    sxp = pos_vs @ plane_xp[:, :3].T - plane_xp[None, :, 3]
    sym = pos_vs @ plane_ym[:, :3].T - plane_ym[None, :, 3]  # (L, FY)
    syp = pos_vs @ plane_yp[:, :3].T - plane_yp[None, :, 3]
    vx = (sxm >= -r[:, None]) & (sxp >= -r[:, None])  # (L, FX)
    vy = (sym >= -r[:, None]) & (syp >= -r[:, None])  # (L, FY)

    # z slab tests: near plane (0,0,-1, near_d): -z - near_d >= -r
    z = pos_vs[:, 2]
    vz_near = (-z[:, None] - near_d[None, :]) >= -r[:, None]  # (L, FZ)
    vz_far = (z[:, None] + far_d[None, :]) >= -r[:, None]
    vz = vz_near & vz_far

    in_range = jnp.arange(n_l) < l_count
    vis = (
        vx[:, :, None, None]
        & vy[:, None, :, None]
        & vz[:, None, None, :]
        & in_range[:, None, None, None]
    )  # (L, FX, FY, FZ)
    vis = jnp.moveaxis(vis, 0, -1)  # (FX, FY, FZ, L)

    counts = jnp.minimum(
        vis.sum(axis=-1).astype(jnp.int32), MAX_POINT_INDICES
    )
    order = jnp.argsort(~vis, axis=-1, stable=True)  # ascending light index
    lists = order[..., :MAX_POINT_INDICES].astype(jnp.int32)

    return {
        "point_lists": lists,
        "point_counts": counts,
        "spot_count": lights["spot_count"],
    }


def cluster_index_z(z_cam, near, far):
    """Doom slice index for view-space z (light_clusters.glsl:41-50)."""
    ratio = jnp.log(jnp.maximum(-z_cam / near, 1e-20)) / jnp.log(far / near)
    return jnp.clip(
        (Z_SLICE_COUNT * ratio).astype(jnp.int32), 0, Z_SLICE_COUNT - 1
    )


def eval_clustered_lights(
    surface: dict,
    lights: dict,
    clusters: dict,
    px: jnp.ndarray,
    py: jnp.ndarray,
    z_cam: jnp.ndarray,
    near,
    far,
):
    """Point+spot evaluation via the pixel's froxel list
    (light_clusters.glsl evalPointLights/evalSpotLights)."""
    fx_i = (px // LIGHT_CLUSTER_DIMENSION).astype(jnp.int32)
    fy_i = (py // LIGHT_CLUSTER_DIMENSION).astype(jnp.int32)
    fz_i = cluster_index_z(z_cam, near, far)

    plists = clusters["point_lists"][fx_i, fy_i, fz_i]  # (R, 128)
    pcounts = clusters["point_counts"][fx_i, fy_i, fz_i]  # (R,)
    pos = surface["position_ws"]

    def brdf_l(l):
        return eval_brdf_times_nol(
            l,
            surface["inv_view_ray"],
            surface["normal_ws"],
            surface["albedo"],
            surface["roughness"],
            surface["metallic"],
        )

    max_count = jnp.max(pcounts)
    use_packed = "packed_rows" in lights

    def point_body(k, acc):
        idx = plists[:, k]
        if use_packed:
            # packed rows: sun at 0, counted points at 1.. (one gather)
            from ..render.shading import sample_light_packed

            l, _, irr = sample_light_packed(lights["packed_rows"], idx + 1, pos)
        else:
            l, _, irr = point_light_irradiance(lights, idx, pos)
        contrib = irr * brdf_l(l)
        return acc + jnp.where((k < pcounts)[..., None], contrib, 0.0)

    color = jax.lax.fori_loop(
        0, max_count, point_body, jnp.zeros_like(pos)
    )

    # spots: all visible (reference quirk), plain loop over count
    pc = lights["point_count"]

    def spot_body(k, acc):
        if use_packed:
            from ..render.shading import sample_light_packed

            l, _, irr = sample_light_packed(
                lights["packed_rows"],
                jnp.full(pos.shape[:-1], 0, jnp.int32) + (1 + pc + k),
                pos,
            )
        else:
            l, _, irr = spot_light_irradiance(
                lights, jnp.full(pos.shape[:-1], k, jnp.int32), pos
            )
        contrib = irr * brdf_l(l)
        return acc + contrib

    color = jax.lax.fori_loop(0, lights["spot_count"], spot_body, color)
    return color
