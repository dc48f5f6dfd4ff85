"""Multi-device rendering: pixel-parallel sharding over a device mesh.

The reference is single-GPU; its scale axes are pixels/tiles/rays
(SURVEY.md §5). The mapping here is SPMD pixel-space decomposition:
every device traces a horizontal band of the frame with the (small)
scene replicated, and frame-level statistics are combined with psum.
This module builds that step with jax.sharding.Mesh + shard_map; XLA
lowers the collectives (NCCL over NVLink on a GPU host). The mesh is
flat (1-D), which fits an all-to-all NVLink host.

Axes:
- "sp": spatial/pixel parallelism (bands of the frame)

Scene replication is the right default below ~1 GB of scene; a geometry-
sharded ("gp") variant can all_gather cluster slabs on demand for huge
scenes (future work, noted in ROADMAP).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .pt import pt_trace_pixels


def make_mesh(n_devices: int | None = None, axis: str = "sp") -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(devs, (axis,))


def pt_render_sharded(
    mesh: Mesh,
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    width: int,
    height: int,
    frame_index: int,
    max_bounces: int = 2,
    use_dof: bool = False,
    env: jnp.ndarray | None = None,
    alpha_rounds: int = 0,
):
    """One 1-spp PT sample with pixels sharded over the mesh's "sp" axis.

    env / alpha_rounds / use_dof ride through to pt_trace_pixels (env is
    closed over, so XLA replicates the cubemap to every chip — it is
    scene data like the geometry arenas).

    Returns ((H*W, 3) color gathered, total ray count psummed over chips).
    """
    n = mesh.shape["sp"]
    R = width * height
    assert R % n == 0, "pixel count must divide the mesh"

    px = jnp.tile(jnp.arange(width, dtype=jnp.uint32), height)
    py = jnp.repeat(jnp.arange(height, dtype=jnp.uint32), width)
    res = jnp.array([width, height], jnp.int32)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("sp"), P("sp"), P()),
        out_specs=(P("sp"), P()),
        # while_loop carries mix replicated loop counters with sharded ray
        # state; skip the varying-manual-axes type check
        check_vma=False,
    )
    def step(static_r, frame_r, arena_r, cam_r, px_s, py_s, res_r):
        color, n_rays = pt_trace_pixels(
            static_r,
            frame_r,
            arena_r,
            cam_r,
            px_s,
            py_s,
            res_r,
            frame_index,
            max_bounces,
            use_dof=use_dof,
            env=env,
            alpha_rounds=alpha_rounds,
        )
        total_rays = jax.lax.psum(n_rays, "sp")
        return color, total_rays

    fn = jax.jit(step)
    return fn(static_scene, frame, arena, cam, px, py, res)


def restir_render_sharded(
    mesh: Mesh,
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    width: int,
    height: int,
    frame_index: int,
):
    """Full ReSTIR DI frame with horizontal pixel bands sharded over the
    mesh's "sp" axis.

    Each chip renders `height/n` rows: G-buffer band (render_gbuffer
    y_offset), initial reservoirs, then spatial reuse against a
    band+halo neighbor image built by exchanging SPATIAL_RADIUS edge
    rows with adjacent devices (jax.lax.ppermute — the multi-device
    stand-in for the reference's single-GPU texture fetch across the
    whole frame), and traced shading. Per-pixel RNG streams use absolute
    pixel coordinates, so the result matches the single-chip
    render_restir pipeline.

    Returns (H*W, 3) linear color (sharded by band).
    """
    from .gbuffer import render_gbuffer
    from .restir import (
        SPATIAL_RADIUS,
        initial_reservoirs,
        pack_neighbor_rows,
        restir_shade,
        spatial_reuse,
    )
    from ..ops import trace

    n = mesh.shape["sp"]
    # equal bands of ceil(height / n) rows; rows past the real frame
    # trace below the frustum (invalid G-buffer -> empty reservoirs) and
    # are cropped after the gather, so any (height, n) combination works
    band_h = -(-height // n)
    # spatial_reuse offsets are uniformSampleDisk*2R - R, i.e. asymmetric
    # [-3R, +R] px (spatial_reuse.comp:47): neighbors reach up to 3R rows
    # ABOVE a pixel but only R rows below, so the halo from above must be
    # 3R rows while R rows suffice from below. Bands shorter than the
    # halo pull slabs from several chips away via multi-hop ppermute.
    halo_up = int(3 * SPATIAL_RADIUS)
    halo_dn = int(SPATIAL_RADIUS)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P("sp"),
        check_vma=False,
    )
    def step(static_r, frame_r, arena_r, cam_r):
        d = jax.lax.axis_index("sp")
        y0 = d * band_h
        gbuf = render_gbuffer(
            static_r, frame_r, arena_r, cam_r, width, band_h,
            y_offset=y0, full_height=height,
        )
        surface = dict(gbuf["surface"])
        c2c = cam_r["camera_to_clip"]
        lin = -c2c[2, 3] / (gbuf["depth"] + c2c[2, 2])
        surface["linear_depth"] = lin
        gbuf2 = dict(gbuf)
        gbuf2["linear_depth"] = lin

        px = jnp.tile(jnp.arange(width, dtype=jnp.uint32), band_h)
        py = (
            jnp.repeat(jnp.arange(band_h, dtype=jnp.uint32), width)
            + y0.astype(jnp.uint32)
        )
        lights = frame_r["lights"]

        li0, ucw0 = initial_reservoirs(surface, lights, px, py, frame_index)
        li0 = jnp.where(gbuf["valid"], li0, -1)

        rows = pack_neighbor_rows(gbuf2, li0, ucw0).reshape(band_h, width * 8)
        # halo exchange: chip d needs rows [y0-halo_up, y0) from the
        # chips above and [y0+band_h, y0+band_h+halo_dn) from below.
        # Hop j pulls the adjacent slab from chip d-+j; frame-edge chips
        # receive zeros (empty reservoirs, rejected by the depth/normal
        # heuristics).
        above = []  # top-to-bottom: farthest chip's slab first
        k_up = -(-halo_up // band_h)
        for j in range(k_up, 0, -1):
            s_j = min(band_h, halo_up - (j - 1) * band_h)
            perm = [(i, i + j) for i in range(n - j)]
            above.append(jax.lax.ppermute(rows[-s_j:], "sp", perm))
        below = []
        k_dn = -(-halo_dn // band_h)
        for j in range(1, k_dn + 1):
            s_j = min(band_h, halo_dn - (j - 1) * band_h)
            perm = [(i + j, i) for i in range(n - j)]
            below.append(jax.lax.ppermute(rows[:s_j], "sp", perm))
        halo_rows = jnp.concatenate(above + [rows] + below, axis=0)
        neigh = halo_rows.reshape((band_h + halo_up + halo_dn) * width, 8)

        li1, ucw1 = spatial_reuse(
            surface, lights, neigh, px, py, width, height, frame_index,
            neigh_y0=y0 - halo_up, neigh_rows_h=band_h + halo_up + halo_dn,
        )
        surface["valid"] = gbuf["valid"]
        tracer = trace.make_tracer(static_r, frame_r)
        return restir_shade(surface, lights, li1, ucw1, tracer)

    out = jax.jit(step)(static_scene, frame, arena, cam)
    return out[: height * width]  # crop band padding (rows past the frame)


def deferred_render_sharded(
    mesh: Mesh,
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    width: int,
    height: int,
    ibl_data: dict | None = None,
):
    """Core deferred frame (G-buffer -> clustered shading [-> skybox])
    with horizontal pixel bands sharded over the mesh's "sp" axis.

    Froxel coordinates stay absolute (band rows must align to the 32 px
    froxel tile), so every chip shades exactly the light set the
    single-chip path would. Post (TAA/bloom/DoF/tone map) runs on the
    gathered frame — its 3x3 neighborhoods would only need a 1-px halo,
    which is not worth a collective at current frame rates.

    Returns (H*W, 3) linear HDR color (sharded by band).
    """
    from .deferred import shade_deferred
    from .gbuffer import render_gbuffer
    from ..ops.clustering import build_light_clusters

    n = mesh.shape["sp"]
    # Bands pad UP to the 32 px froxel tile instead of asserting (1080
    # rows over 8 devices = 135-row bands): each device renders
    # ceil(height / n) rows rounded to the tile, rows past the real frame
    # trace harmlessly below the frustum and are cropped after the
    # gather. The froxel grid stays the full frame's (build_light_clusters
    # at the REAL height), so every band shades the single-device light
    # sets.
    band_h = -(-height // (n * 32)) * 32

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P("sp"),
        check_vma=False,
    )
    def step(static_r, frame_r, arena_r, cam_r):
        d = jax.lax.axis_index("sp")
        y0 = d * band_h
        gbuf = render_gbuffer(
            static_r, frame_r, arena_r, cam_r, width, band_h,
            y_offset=y0, full_height=height,
        )
        clusters = build_light_clusters(
            cam_r, frame_r["lights"], width, height
        )
        color = shade_deferred(
            gbuf, clusters, frame_r["lights"], cam_r, width, band_h,
            ibl_data, y_offset=y0,
        )
        if ibl_data is not None and "env" in ibl_data:
            from ..ops.ibl import sample_cubemap
            from ..ops.rays import pinhole_rays

            ys = (
                jnp.repeat(jnp.arange(band_h, dtype=jnp.float32), width)
                + y0
                + 0.5
            ) / height
            xs = (
                jnp.tile(jnp.arange(width, dtype=jnp.float32), band_h) + 0.5
            ) / width
            _, vd = pinhole_rays(cam_r, jnp.stack([xs, ys], -1))
            sky = sample_cubemap(ibl_data["env"], vd)
            color = jnp.where(gbuf["valid"][:, None], color, sky)
        return color

    out = jax.jit(step)(static_scene, frame, arena, cam)
    return out[: height * width]  # crop band padding (rows past the frame)


def replicate_to_mesh(tree, mesh: Mesh):
    """Place a pytree replicated on every device of the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def sharded_render_modes(mesh: Mesh):
    """CLI-facing multi-chip mode table (the `--devices N` path): same
    (img, state) entry protocol as render/frame.render_modes, with the
    heavy per-pixel work sharded over the mesh. Post-chain flags
    (TAA/bloom/DoF/particles/culling) are the single-chip entries'
    domain; the CLI warns and drops them in sharded mode.
    """
    from .pt import pt_accumulate
    from ..ops.tonemap import tone_map

    def pt_mode(
        *, static, frame, arena, cam, lut, width, height, exposure=1.0,
        contrast=1.0, max_bounces=3, frame_index=0, state=None, env=None,
        alpha_rounds=0, **_,
    ):
        color, _n_rays = pt_render_sharded(
            mesh, static, frame, arena, cam, width, height, frame_index,
            max_bounces, env=env, alpha_rounds=alpha_rounds,
        )
        sample = color.reshape(height, width, 3)
        if state is None:
            acc = sample
            count = jnp.ones((height, width), jnp.float32)
        else:
            acc, count = pt_accumulate(state[0], state[1], sample)
        img = tone_map(acc, lut, exposure, contrast)
        return img, (acc, count)

    def restir_mode(
        *, static, frame, arena, cam, lut, width, height, exposure=1.0,
        contrast=1.0, frame_index=0, state=None, **_,
    ):
        color = restir_render_sharded(
            mesh, static, frame, arena, cam, width, height, frame_index
        ).reshape(height, width, 3)
        if state is None:
            acc = color
            count = jnp.ones((height, width), jnp.float32)
        else:
            prev, pcount = state
            count = pcount + 1.0
            acc = prev + (color - prev) / count[..., None]
        img = tone_map(acc, lut, exposure, contrast)
        return img, (acc, count)

    def deferred_mode(
        *, static, frame, arena, cam, lut, width, height, exposure=1.0,
        contrast=1.0, state=None, ibl_data=None, **_,
    ):
        color = deferred_render_sharded(
            mesh, static, frame, arena, cam, width, height, ibl_data
        ).reshape(height, width, 3)
        img = tone_map(color, lut, exposure, contrast)
        return img, {"hdr": color}

    return {"pt": pt_mode, "restir": restir_mode, "deferred": deferred_mode}
