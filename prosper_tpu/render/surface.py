"""Hit -> VisibleSurface evaluation: attribute gather, barycentric
interpolation, world transform, material sampling, normal mapping.

Parity with evaluateSurface in the reference's raygen
(/root/reference/res/shader/rt/reference/main.rgen:146-180) and
visible_surface.glsl; mappedNormal from mikktspace.com (main.rgen:37-45).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.texture import sample_material


def _normalize(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def mapped_normal(normal_ts, n, t, sgn):
    """Tangent-space normal -> world (main.rgen:37-45)."""
    b = sgn[..., None] * jnp.cross(n, t)
    return _normalize(
        normal_ts[..., 0:1] * t + normal_ts[..., 1:2] * b + normal_ts[..., 2:3] * n
    )


def pixel_cone_alpha(cam: dict, height: int):
    """Per-pixel ray-cone spread angle: 2*tan(fov/2)/height."""
    return 2.0 / (jnp.abs(cam["camera_to_clip"][1, 1]) * height)


def cone_lod(hit: dict, ray_d, n_ws, cone: dict):
    """Ray-cone texture LOD (the raster path's derivative mip analog):
    footprint = t * pixel spread / |cos theta|; per-triangle uv density
    rides in hit["tri_lod"] (0.5*log2(uv_area/world_area), from the
    gathered triangle, see evaluate_surface). cone = {"alpha": pixel spread, "bias": lodBias
    (-1 under TAA, Renderer.cpp:709-715)}."""
    cosd = jnp.abs(jnp.sum(ray_d * n_ws, axis=-1))
    t_hit = jnp.where(jnp.isfinite(hit["t"]), hit["t"], 0.0)
    width = jnp.maximum(t_hit, 1e-6) * cone["alpha"] / jnp.maximum(cosd, 0.05)
    return hit["tri_lod"] + jnp.log2(width) + cone.get("bias", 0.0)


def hit_material_uv(static_scene: dict, hit: dict):
    """(material (R,), uv (R, 2)) at closest hits: the post-trace
    attribute gather the alpha tests need (stochastic any-hit in PT,
    mask discard in the raster-analog passes)."""
    tri = jnp.maximum(hit["tri"], 0)
    aidx = static_scene["wt_aidx"][tri]
    ap = static_scene["a_packed"]
    u = hit["u"][..., None]
    v = hit["v"][..., None]
    uv = (
        (1.0 - u - v) * ap[aidx[..., 0], 7:9]
        + u * ap[aidx[..., 1], 7:9]
        + v * ap[aidx[..., 2], 7:9]
    )
    return static_scene["wt_material"][tri], uv


def evaluate_surface(
    static_scene: dict,
    frame: dict,
    arena: dict,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    hit: dict,
    lod=None,
    cone: dict | None = None,
):
    """Gather/interpolate vertex attributes at hits and sample materials.

    hit: dict from trace_closest (t, tri, u, v); tri < 0 = miss (outputs
    are garbage-but-finite there; callers mask).

    Returns a VisibleSurface dict: position_ws, normal_ws, geo_normal_ws,
    uv, albedo, alpha, roughness, metallic, material (R,), NoV,
    inv_view_ray (unit, towards eye), linear_depth, valid.
    """
    tri = jnp.maximum(hit["tri"], 0)
    u = hit["u"][..., None]
    v = hit["v"][..., None]
    w = 1.0 - u - v

    aidx = static_scene["wt_aidx"][tri]  # (R, 3) vertex arena indices
    ap = static_scene["a_packed"]  # (V, 12): n3 | t4 | uv2 | pad

    a0, a1, a2 = ap[aidx[..., 0]], ap[aidx[..., 1]], ap[aidx[..., 2]]
    # interpolate(v0,v1,v2, baryCoord): w*v0 + u*v1 + v*v2
    ai = w * a0 + u * a1 + v * a2
    n_obj = ai[..., 0:3]
    t_obj4 = ai[..., 3:7]
    uv = ai[..., 7:9]

    inst = static_scene["wt_instance"][tri]
    if "inst_packed" in frame:
        # one (R, 21) row gather: 3x4 transform | 3x3 normal matrix
        ip = frame["inst_packed"][inst]
        m = ip[..., :12].reshape(ip.shape[:-1] + (3, 4))
        nm = ip[..., 12:21].reshape(ip.shape[:-1] + (3, 3))
    else:
        nm = frame["normal_transforms"][inst]  # (R, 3, 3)
        m = frame["transforms"][inst]  # (R, 3, 4)
    n_ws = _normalize(jnp.einsum("...ij,...j->...i", nm, n_obj))
    t_ws = _normalize(jnp.einsum("...ij,...j->...i", m[..., :3], t_obj4[..., :3]))
    t_sign = t_obj4[..., 3]

    position = ray_o + hit["t"][..., None] * ray_d

    material = static_scene["wt_material"][tri]
    duv_major = None
    aniso_taps = int((cone or {}).get("aniso_taps", 1))
    if cone is not None and lod is None:
        # ray-cone LOD from the gathered triangle (see cone_lod)
        p0 = static_scene["wt_p0"][tri]
        p1 = static_scene["wt_p1"][tri]
        p2 = static_scene["wt_p2"][tri]
        e1w = jnp.einsum("...ij,...j->...i", m[..., :3], p1 - p0)
        e2w = jnp.einsum("...ij,...j->...i", m[..., :3], p2 - p0)
        w_area = jnp.linalg.norm(jnp.cross(e1w, e2w), axis=-1)
        uve1 = a1[..., 7:9] - a0[..., 7:9]
        uve2 = a2[..., 7:9] - a0[..., 7:9]
        uv_area = jnp.abs(
            uve1[..., 0] * uve2[..., 1] - uve1[..., 1] * uve2[..., 0]
        )
        tri_lod = 0.5 * jnp.log2(
            jnp.maximum(uv_area, 1e-20) / jnp.maximum(w_area, 1e-20)
        )
        if aniso_taps > 1:
            # anisotropic ray-cone footprint (maxAnisotropy=16 parity,
            # WorldData.cpp:693-714): minor axis = cone width, major =
            # width / cos(theta) along the in-plane view direction,
            # ratio clamped to 16; the world major axis maps to uv via
            # the triangle's edge basis (Gram solve).
            cosd = jnp.abs(jnp.sum(ray_d * n_ws, axis=-1))
            t_hit = jnp.where(jnp.isfinite(hit["t"]), hit["t"], 0.0)
            w_minor = jnp.maximum(t_hit, 1e-6) * cone["alpha"]
            ratio = jnp.clip(1.0 / jnp.maximum(cosd, 1e-3), 1.0, 16.0)
            mdir = ray_d - n_ws * jnp.sum(ray_d * n_ws, axis=-1)[..., None]
            mdir = mdir / jnp.maximum(
                jnp.linalg.norm(mdir, axis=-1, keepdims=True), 1e-9
            )
            vec = mdir * (w_minor * ratio)[..., None]
            g11 = jnp.sum(e1w * e1w, axis=-1)
            g12 = jnp.sum(e1w * e2w, axis=-1)
            g22 = jnp.sum(e2w * e2w, axis=-1)
            det = jnp.maximum(g11 * g22 - g12 * g12, 1e-20)
            b1 = jnp.sum(e1w * vec, axis=-1)
            b2 = jnp.sum(e2w * vec, axis=-1)
            x = (g22 * b1 - g12 * b2) / det
            y = (g11 * b2 - g12 * b1) / det
            duv_major = x[..., None] * uve1 + y[..., None] * uve2
            lod = (
                tri_lod
                + jnp.log2(jnp.maximum(w_minor, 1e-8))
                + cone.get("bias", 0.0)
            )
        else:
            lod = cone_lod(
                {"tri_lod": tri_lod, "t": hit["t"]}, ray_d, n_ws, cone
            )
    if "mat_f32" in arena:
        from ..ops.texture import sample_material_packed

        mat = sample_material_packed(
            arena, material, uv, lod,
            duv_major=duv_major, aniso_taps=aniso_taps,
        )
    else:
        mat = sample_material(
            arena, static_scene["materials"], material, uv, lod,
            footprint=cone is not None,
        )

    # normal mapping when a normal texture and a real tangent exist
    has_map = (mat["normal_ts"][..., 0] != -2.0) & (t_sign != 0.0)
    n_mapped = mapped_normal(mat["normal_ts"], n_ws, t_ws, t_sign)
    normal_ws = jnp.where(has_map[..., None], n_mapped, n_ws)

    inv_view = -ray_d
    NoV = jnp.clip(jnp.sum(normal_ws * inv_view, axis=-1), 0.0, 1.0)

    return {
        "valid": hit["tri"] >= 0,
        "position_ws": position,
        "normal_ws": normal_ws,
        "uv": uv,
        "albedo": mat["albedo"],
        "alpha": mat["alpha"],
        "roughness": mat["roughness"],
        "metallic": mat["metallic"],
        "material": material,
        "instance": inst,
        "inv_view_ray": inv_view,
        "NoV": NoV,
        "linear_depth": hit["t"],
    }
