"""G-buffer generation via primary-visibility ray casting.

The reference rasterises meshlets into albedo+roughness / signed-oct
normal+metalness / velocity / depth targets
(/root/reference/res/shader/gbuffer.frag, formats RenderTargets.hpp:11-14).
Here primary visibility comes from the same cluster tracer; the
G-buffer encodings are kept bit-compatible:
- albedoRoughness: rgb albedo + a roughness
- normalMetallic: signed-octahedron normal (xy + z sign) + metalness
- velocity: NDC motion with jitter removed, y negated, clamped [-1,1]
  (gbuffer.frag:74-84)
- depth: reverse-z non-linear depth (D32 analog)
"""

from __future__ import annotations

import jax.numpy as jnp

from ..mathx.packing import pack_velocity, signed_oct_encode
from ..ops import trace
from ..ops.rays import pinhole_rays
from .surface import evaluate_surface, hit_material_uv


def mask_discard_retrace(arena, static_scene, trace_fn, o, d, hit,
                         rounds: int):
    """Alpha-mask discard for the raster-analog paths (gbuffer.frag:61-63,
    forward.frag:56-58: fragments whose mask test failed are `discard`ed).

    Deterministic, unlike PT's stochastic any-hit: a hit on an
    alphaMode==MASK material whose sampled alpha fails the cutoff is
    ignored and the ray re-traced from just past it, up to `rounds`
    layers. Rays that need no re-trace carry t_max = 0, which the tracers
    reject at once; rays (o, d) and `hit` (t, tri, u, v) must be in the
    same order."""
    from ..ops.texture import sample_alpha_packed

    hit = dict(hit)
    mat, _ = hit_material_uv(static_scene, hit)
    cand = (hit["tri"] >= 0) & (arena["mat_i32"][mat, 0] == 1)
    t_off = jnp.zeros_like(hit["t"])
    for _ in range(rounds):
        a = sample_alpha_packed(arena, *hit_material_uv(static_scene, hit))
        ignore = cand & (hit["tri"] >= 0) & (a == 0.0)
        adv = jnp.where(ignore, hit["t"] * (1.0 + 1e-4) + 1e-5, 0.0)
        o = o + d * adv[..., None]
        t_off = t_off + adv
        hit2 = trace_fn(o, d, 0.0, jnp.where(ignore, jnp.inf, 0.0))
        hit = {k: jnp.where(ignore, hit2[k], hit[k]) for k in hit}
    hit["t"] = hit["t"] + t_off
    return hit


def render_gbuffer(
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    width: int,
    height: int,
    use_culling: bool = False,
    prev_hiz: list | None = None,
    lod_bias: float = 0.0,
    y_offset=0,
    full_height: int | None = None,
    alpha_rounds: int = 0,
    aniso_taps: int = 1,
):
    """Trace primary rays and produce the G-buffer pytree (flat R = W*H,
    row-major).

    aniso_taps > 1 enables anisotropic material filtering (the
    reference's maxAnisotropy=16 samplers, WorldData.cpp:693-714):
    that many trilinear taps along the uv-space major footprint axis.

    y_offset/full_height render a horizontal BAND of a taller frame
    (multi-device pixel sharding, render/distributed.py): `height` rows
    starting at absolute row y_offset of a full_height frame, with the
    camera projection unchanged. y_offset may be traced (per-device
    axis_index); culling is not supported per-band.

    With use_culling, runs the reference's two-phase meshlet pipeline
    (ForwardRenderer recordOpaque flow): phase 1 traces clusters that
    survive frustum/cone culling + previous-frame HiZ occlusion; a fresh
    HiZ is built from phase-1 depth; phase 2 re-tests the depth-culled
    clusters against it and traces the disocclusions; hits merge by min t.
    The fresh HiZ is returned in the G-buffer for preservation.
    """
    full_h = height if full_height is None else full_height
    # row-major pixel-center rays; the TAA jitter rides the camera matrix
    # like the raster path's jittered projection
    uv = jnp.stack(
        [
            (jnp.tile(jnp.arange(width, dtype=jnp.float32), height) + 0.5)
            / width,
            (
                jnp.repeat(jnp.arange(height, dtype=jnp.float32), width)
                + y_offset
                + 0.5
            )
            / full_h,
        ],
        axis=-1,
    )
    jit = cam["current_jitter"]
    o, d = pinhole_rays(cam, uv + jit * jnp.array([0.5, -0.5]))

    tracer = trace.make_tracer(static_scene, frame)
    stats = {}
    hiz_mips = None
    if use_culling:
        from ..ops.culling import cull_clusters
        from ..ops.hiz import build_hiz

        uniform_scales = jnp.linalg.norm(
            frame["transforms"][:, :, :3], axis=1
        ).max(axis=-1)
        cull1 = cull_clusters(
            static_scene,
            frame,
            cam,
            uniform_scales,
            prev_hiz or [],
            width,
            height,
            output_second_phase=True,
        )
        hit = tracer.closest(o, d, 1e-4, jnp.inf, cull1["visible"])

        # fresh HiZ from phase-1 depth
        w2clip = cam["camera_to_clip"] @ cam["world_to_camera"]
        pos1 = o + jnp.where(jnp.isfinite(hit["t"]), hit["t"], 0.0)[..., None] * d
        ph = jnp.concatenate([pos1, jnp.ones_like(pos1[..., :1])], -1)
        clip = ph @ w2clip.T
        depth1 = jnp.where(hit["tri"] >= 0, clip[..., 2] / clip[..., 3], 0.0)
        depth_img = depth1.reshape(height, width)
        hiz_mips = build_hiz(depth_img, width, height)

        # phase 2: disoccluded clusters only
        from ..ops.culling import sphere_occluded, transform_cluster_bounds

        center, radius, _axis, _cut = transform_cluster_bounds(
            static_scene, frame, uniform_scales
        )
        still_occluded = sphere_occluded(
            center, radius, cam, hiz_mips, width, height
        )
        phase2 = cull1["second_phase"] & ~still_occluded
        hit2 = tracer.closest(o, d, 1e-4, jnp.inf, phase2)
        better = hit2["t"] < hit["t"]
        hit = {k: jnp.where(better, hit2[k], hit[k]) for k in hit}
        stats = {
            "drawn_meshlets": cull1["drawn_meshlets"] + phase2.sum(),
            "rasterized_triangles": cull1["rasterized_triangles"],
        }
    else:
        hit = tracer.closest(o, d, 1e-4, jnp.inf)
    if alpha_rounds and "mat_i32" in arena:
        # alpha-mask discard (gbuffer.frag:61-63): failed-mask hits are
        # re-traced past the cut-out instead of shading opaque
        hit = mask_discard_retrace(
            arena, static_scene, tracer.closest, o, d, hit, alpha_rounds
        )
    # ray-cone mip selection: the raster path's derivative LOD analog,
    # lodBias -1 under TAA (Renderer.cpp:709-715)
    from .surface import pixel_cone_alpha

    cone = {
        "alpha": pixel_cone_alpha(cam, full_h),
        "bias": lod_bias,
        "aniso_taps": aniso_taps,
    }

    valid = hit["tri"] >= 0
    surface = evaluate_surface(
        static_scene, frame, arena, o, d, hit, cone=cone
    )
    surface.pop("instance", None)
    # zero every field of a miss pixel (its hit row is not a surface)
    surface = {
        k: jnp.where(valid.reshape(valid.shape + (1,) * (v.ndim - 1)), v, 0)
        .astype(v.dtype)
        for k, v in surface.items()
    }
    surface["valid"] = valid
    # safe default normal on misses (signed-oct encode of 0 would be NaN)
    surface["normal_ws"] = jnp.where(
        valid[..., None], surface["normal_ws"], jnp.array([0.0, 0.0, 1.0])
    )

    pos = surface["position_ws"]
    pos_safe = jnp.where(valid[..., None], pos, 0.0)

    # current and previous clip positions for velocity (gbuffer.frag:74-84)
    def project(m, p):
        ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
        clip = ph @ m.T
        return clip[..., :3] / jnp.maximum(jnp.abs(clip[..., 3:4]), 1e-20) * jnp.sign(
            clip[..., 3:4]
        )

    ndc = project(cam["world_to_clip"], pos_safe)
    prev_ndc = project(cam["prev_world_to_clip"], pos_safe)
    velocity = (ndc[..., :2] - cam["current_jitter"]) - (
        prev_ndc[..., :2] - cam["previous_jitter"]
    )
    velocity = velocity.at[..., 1].multiply(-1.0)
    velocity = pack_velocity(velocity)

    # view-space z for froxel lookup
    w2c = cam["world_to_camera"]
    z_cam = pos_safe @ w2c[2, :3] + w2c[2, 3]

    gbuf = {
        "albedo_roughness": jnp.concatenate(
            [surface["albedo"], surface["roughness"][..., None]], axis=-1
        ),
        "normal_metallic": jnp.concatenate(
            [
                signed_oct_encode(surface["normal_ws"]),
                surface["metallic"][..., None],
            ],
            axis=-1,
        ),
        "velocity": jnp.where(valid[..., None], velocity, 0.0),
        "depth": jnp.where(valid, ndc[..., 2], 0.0),  # reverse-z: far = 0
        "z_cam": jnp.where(valid, z_cam, -jnp.inf),
        "position_ws": pos_safe,
        "valid": valid,
        # carried for shading without re-deriving from encodings (the
        # deferred shader decodes; tests assert the encodings round-trip)
        "surface": surface,
        "hiz": hiz_mips,
        "draw_stats": stats,
    }
    return gbuf
