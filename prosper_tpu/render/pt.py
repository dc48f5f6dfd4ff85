"""Wavefront path tracer — reference-mode parity.

Algorithm parity with /root/reference/res/shader/rt/reference/main.rgen:
- pcg_state = uvec3(px, frameIndex); jittered uv (:227-231)
- pinhole or thin-lens primary rays (:236-240)
- per bounce: closest hit -> direct light (uniform light pick + shadow ray
  with tMin 0.1, :196-226) -> diffuse/specular one-sample MIS bounce
  (cosine hemisphere vs VNDF, 50/50 or specular-only when metallic>0.999,
  :92-144) -> Russian roulette after rouletteStartBounce (:270-276)
- indirect clamp to [0,2] when enabled (:84-89)
- running-mean accumulation with history count (:284-297)
- Wächter-Binder ray offset between bounces (:278)

RNG stream order matches the GLSL call-for-call so fp32 sample streams
line up: uv jitter (1 advance), [lens (1)], then per bounce: light pick
(1), bounce pick (1), bounce dir (1), [roulette (1)].

Structure: the primary trace runs dense over all pixels in row-major
order; the rest of the frame (surface eval, NEE, bounce traces) runs on
a tile-compacted wavefront. Tiles of 256 consecutive pixels with no
primary hit are dropped by a prefix-sum compaction over TILE-granular
masks (cheap: ~R/256 elements), and the surviving tiles are processed
in fixed-capacity chunks with a DYNAMIC chunk count (lax.fori_loop with
a traced bound). On sparse scenes this removes ~(1 - coverage) of all
texture taps, BRDF math and shadow rays. This is the wavefront analog of
the reference megakernel's early ray termination (rays that miss never
run the hit shader). Inside a chunk every bounce runs over all of the
chunk's lanes: re-compacting per bounce measured slower on the GPU
(PERF.md).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..mathx import rng as prng
from ..ops import trace
from ..ops.brdf import (
    cook_torrance_brdf,
    cosine_hemisphere_pdf,
    cosine_sample_hemisphere,
    eval_brdf_times_nol,
    fresnel_zero,
    lambert_brdf,
    orthonormal_basis,
    sample_visible_trowbridge_reitz,
    saturate,
    visible_trowbridge_reitz_pdf,
)
from ..ops.rays import offset_ray, pinhole_rays, thin_lens_rays
from ..ops.tonemap import tone_map
from .shading import sample_light
from .surface import evaluate_surface

ROULETTE_START_BOUNCE = 1  # reference UI default (RtReference.hpp)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def pt_trace_pixels(
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    px: jnp.ndarray,
    py: jnp.ndarray,
    resolution: jnp.ndarray,
    frame_index,
    max_bounces: int = 3,
    use_dof: bool = False,
    clamp_indirect: bool = False,
    env: jnp.ndarray | None = None,
    alpha_rounds: int = 0,
    chunk_tiles: int = 512,
):
    """Path-trace an arbitrary flat pixel list -> ((R,3) color, ray count).

    alpha_rounds > 0 enables stochastic-alpha any-hit parity
    (scene.rahit): ignored hits (failed mask test, or blend alpha below a
    per-ray uniform) re-trace from just past the hit, up to alpha_rounds
    times. The per-ray uniform is fixed per traceRay like the reference's
    payload.randomSeed (scene.rahit:33-38).

    After the dense primary trace, shading and bounces run on a
    tile-compacted wavefront: 256-ray tiles with no hit are dropped by a
    prefix-sum over ~R/256 tile flags, and survivors are processed in
    chunks of `chunk_tiles` tiles with a dynamic lax.fori_loop trip count
    (see module docstring). Per-pixel RNG streams ride the compaction, so
    results are bit-identical to the dense loop.

    Taking explicit pixel coordinates makes the frame shardable: each
    device of a mesh traces its own pixel slice (render/distributed.py),
    the multi-device strategy standing in for the reference's single-GPU
    viewport (SURVEY.md §5 "sharding axes: pixels/tiles/rays").
    """
    TILE = 256
    if env is not None and env.ndim != 2:
        # quad-pack the cubemap ONCE: sample_cubemap repacking inside the
        # per-chunk/per-bounce fori_loop bodies costs 4x the cubemap's
        # memory traffic per trace step (XLA cannot hoist it out of the
        # loop-carried bodies)
        from ..ops.ibl import pack_cubemap_rows

        env = pack_cubemap_rows(env)
    R0 = px.shape[0]
    pad = (-R0) % TILE
    if pad:
        px = jnp.concatenate([px, jnp.broadcast_to(px[:1], (pad,))])
        py = jnp.concatenate([py, jnp.broadcast_to(py[:1], (pad,))])
    R = px.shape[0]
    n_tiles = R // TILE
    CT = min(chunk_tiles, n_tiles)
    width, height = resolution[0], resolution[1]
    def primary_streams(px_, py_):
        """Per-pixel RNG state + primary ray for (px_, py_) — the
        reference's camera stream (main.rgen rnd2d01 jitter, then the
        optional thin-lens draw). Pure elementwise math, so the chunk
        loop below recomputes its own slice instead of gathering nine
        channels of full-frame tile views."""
        st = prng.make_state(px_, py_, jnp.uint32(frame_index))
        st, jitter = prng.rnd2d01(st)
        uvj = (
            jnp.stack([px_, py_], axis=-1).astype(jnp.float32) + jitter
        ) / jnp.stack([width, height]).astype(jnp.float32)
        if use_dof:
            st, lens = prng.rnd2d01(st)
            o_, d_ = thin_lens_rays(cam, uvj, lens)
        else:
            o_, d_ = pinhole_rays(cam, uvj)
        return st, o_, d_

    tracer = trace.make_tracer(static_scene, frame)
    lights = frame["lights"]
    light_count = (1 + lights["point_count"] + lights["spot_count"]).astype(
        jnp.float32
    )
    def alpha_retrace(state, o, d, tmax, hit):
        """The stochastic any-hit retrace loop (scene.rahit): ignored
        hits (failed mask test / blend alpha below the per-ray uniform)
        re-trace from just past the hit."""
        from ..ops.texture import sample_alpha_packed
        from .surface import hit_material_uv

        # fixed per-ray uniform: pcg(state.x ^ state.z) (no advance),
        # the payload.randomSeed convention
        seed = prng.pcg(state[..., 0] ^ state[..., 2])
        au = prng.rng_to01(seed)
        t_off = jnp.zeros_like(hit["t"])
        o_cur = o
        tmax_cur = tmax
        for _ in range(alpha_rounds):
            a = sample_alpha_packed(
                arena, *hit_material_uv(static_scene, hit)
            )
            ignore = (hit["tri"] >= 0) & (
                (a == 0.0) | ((a > 0.0) & (au > a))
            )
            adv = jnp.where(ignore, hit["t"] * (1.0 + 1e-4) + 1e-5, 0.0)
            o_cur = o_cur + d * adv[..., None]
            tmax_cur = jnp.where(
                ignore, jnp.maximum(tmax_cur - adv, 0.0), 0.0
            )
            t_off = t_off + adv
            hit2 = tracer.closest(o_cur, d, 0.0, tmax_cur)
            hit = {
                k: jnp.where(
                    ignore.reshape(
                        ignore.shape + (1,) * (hit[k].ndim - 1)
                    ),
                    hit2[k],
                    hit[k],
                )
                for k in hit
            }
        hit = dict(hit)
        hit["t"] = hit["t"] + t_off
        return hit

    def trace_with_alpha(state, o, d, tmax):
        """traceRay + the stochastic any-hit retrace loop (scene.rahit)."""
        hit = tracer.closest(o, d, 0.0, tmax)
        if not alpha_rounds:
            return hit
        return alpha_retrace(state, o, d, tmax, hit)

    def miss_hit_like(hit, tmax):
        out = {}
        for k, v in hit.items():
            if k == "t":
                out[k] = tmax
            elif k == "tri":
                out[k] = jnp.full_like(v, -1)
            else:
                out[k] = jnp.zeros_like(v)
        return out

    def shade_and_bounce(bounce, state, color, throughput, active, ray_o,
                         ray_d, hit):
        """Shade one wavefront's hits + generate its bounce rays.

        `bounce` is the hit's bounce index (0 = primary). Everything is
        math-identical to the reference per-pixel loop body
        (main.rgen:196-276); see the RNG-parity notes in the docstrings.
        """
        hit_valid = (hit["tri"] >= 0) & active
        surface = evaluate_surface(
            static_scene, frame, arena, ray_o, ray_d, hit
        )

        # ---- direct lighting (main.rgen:196-226) ----
        # The reference's evaluateDirectLighting returns before its rnd01
        # when the surface alpha == 0 (failed mask test) and is never
        # called on miss, so the light-pick advance is masked per ray to
        # keep bit-exact stream parity on paths through alpha==0 hits.
        state_dl, pick = prng.rnd01(state)
        adv_dl = hit_valid & (surface["alpha"] != 0.0)
        state = jnp.where(adv_dl[..., None], state_dl, state)
        light_index = jnp.minimum(
            (pick * light_count).astype(jnp.uint32),
            (light_count - 1.0).astype(jnp.uint32),
        ).astype(jnp.int32)
        l, dist, irradiance = sample_light(
            lights, light_index, surface["position_ws"]
        )
        front = _dot(l, surface["normal_ws"]) > 0.0
        need_shadow = hit_valid & front & (surface["alpha"] != 0.0)
        # Rays that don't need a shadow keep a finite origin/direction
        # (miss rays have inf positions that would poison packet bounds)
        # and are disabled via t_max = 0, which keeps the conservative
        # cull tight instead of degenerating to all-clusters.
        shadow_o = jnp.where(
            need_shadow[..., None], surface["position_ws"], ray_o
        )
        shadow_d = jnp.where(need_shadow[..., None], l, ray_d)
        shadow_tmax = jnp.where(need_shadow, dist, 0.0)
        occluded = tracer.any(shadow_o, shadow_d, 0.1, shadow_tmax)
        vis = jnp.where(need_shadow & ~occluded, 1.0, 0.0)
        direct = (
            throughput
            * irradiance
            * vis[..., None]
            * light_count
            * eval_brdf_times_nol(
                l,
                surface["inv_view_ray"],
                surface["normal_ws"],
                surface["albedo"],
                surface["roughness"],
                surface["metallic"],
            )
        )
        contrib = jnp.where(hit_valid[..., None], direct, 0.0)
        if clamp_indirect:
            contrib = jnp.where(
                bounce > 0, jnp.clip(contrib, 0.0, 2.0), contrib
            )
        color = color + contrib

        # ---- bounce importance sampling (main.rgen:92-144) ----
        state, pick_u = prng.rnd01(state)
        state, samp = prng.rnd2d01(state)

        specular_only = surface["metallic"] > 0.999
        specular_weight = jnp.where(specular_only, 1.0, 0.5)
        diffuse_weight = 1.0 - specular_weight
        pick_diffuse = pick_u < diffuse_weight

        basis = orthonormal_basis(surface["normal_ws"])  # (R, 3, 3)
        v_basis = jnp.einsum(
            "...ij,...j->...i", basis, surface["inv_view_ray"]
        )
        alpha = surface["roughness"] * surface["roughness"]

        # diffuse branch
        rd_diff = cosine_sample_hemisphere(surface["normal_ws"], samp)
        NoL_diff = saturate(_dot(surface["normal_ws"], rd_diff))
        brdf_diff = lambert_brdf(surface["albedo"])
        pdf_diff = cosine_hemisphere_pdf(NoL_diff) * diffuse_weight

        # specular branch
        rd_spec_basis = sample_visible_trowbridge_reitz(v_basis, alpha, samp)
        rd_spec = jnp.einsum("...ji,...j->...i", basis, rd_spec_basis)
        NoL_spec = saturate(_dot(surface["normal_ws"], rd_spec))
        h = surface["inv_view_ray"] + rd_spec
        h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-20)
        NoH = saturate(_dot(surface["normal_ws"], h))
        VoH = saturate(_dot(surface["inv_view_ray"], h))
        f0 = fresnel_zero(surface["albedo"], surface["metallic"])
        brdf_spec = cook_torrance_brdf(
            NoL_spec, surface["NoV"], NoH, VoH, f0, surface["roughness"]
        )
        pdf_spec = (
            visible_trowbridge_reitz_pdf(v_basis, rd_spec_basis, alpha)
            * specular_weight
        )

        rd = jnp.where(pick_diffuse[..., None], rd_diff, rd_spec)
        brdf = jnp.where(pick_diffuse[..., None], brdf_diff, brdf_spec)
        NoL = jnp.where(pick_diffuse, NoL_diff, NoL_spec)
        pdf = jnp.where(pick_diffuse, pdf_diff, pdf_spec)
        w_raw = brdf * (NoL / pdf)[..., None]
        # GLSL max(brdf*NoL/pdf, 0): max with NaN yields the non-NaN
        # operand on GPUs, so NaN/inf-pdf samples become 0 — emulate that
        # (jnp.maximum would propagate the NaN instead).
        w = jnp.where((w_raw >= 0.0) & jnp.isfinite(w_raw), w_raw, 0.0)
        throughput = jnp.where(
            hit_valid[..., None], throughput * w, throughput
        )

        # ---- Russian roulette (main.rgen:270-276) ----
        # The GLSL advances the RNG only when bounce > rouletteStartBounce;
        # that condition is uniform per bounce, so a masked state advance
        # keeps stream parity.
        rr_on = bounce > ROULETTE_START_BOUNCE
        state_rr, rr = prng.rnd01(state)
        state = jnp.where(rr_on, state_rr, state)
        kill = rr_on & (rr < jnp.maximum(0.05, 1.0 - throughput.max(axis=-1)))
        active = active & ~kill

        active = active & hit_valid
        # Dead rays keep their previous finite origin/direction (tight
        # packet bounds) and are disabled via t_max = 0.
        ray_o = jnp.where(
            active[..., None],
            offset_ray(surface["position_ws"], surface["normal_ws"]),
            ray_o,
        )
        ray_d = jnp.where(active[..., None], rd, ray_d)
        return state, color, throughput, active, ray_o, ray_d, need_shadow

    # ---- dense primary trace over all pixels ----
    lane_real = (
        jnp.arange(R, dtype=jnp.int32) < R0
        if pad
        else jnp.ones((R,), bool)
    )
    tmax0 = jnp.where(lane_real, jnp.inf, 0.0)
    n_rays = jnp.sum(lane_real.astype(jnp.int32))
    state, ray_o, ray_d = primary_streams(px, py)
    # named pass scope: per-pass device attribution via
    # utils/profiler.profile_passes (Profiler.hpp:19-327 analog)
    with jax.named_scope("primary_trace"):
        hit0 = trace_with_alpha(state, ray_o, ray_d, tmax0)
    hit_tri = hit0["tri"]

    color_full = jnp.zeros((R, 3), jnp.float32)
    if env is not None:
        from ..ops.ibl import sample_cubemap

        missed = lane_real & (hit_tri < 0)
        color_full = jnp.where(
            missed[..., None], sample_cubemap(env, ray_d), 0.0
        )

    # ---- tile compaction: keep 256-ray tiles containing any hit ----
    hit_lane = (hit_tri >= 0) & lane_real
    tile_any = jnp.any(hit_lane.reshape(n_tiles, TILE), axis=1)
    # Pad tidx to a CT multiple so the chunk dynamic_slice never clamps
    # (a clamped start re-reads earlier tiles and the color_full scatter
    # would accumulate their radiance twice on near-full-coverage frames).
    tidx_size = ((n_tiles + CT - 1) // CT) * CT
    tidx = jnp.nonzero(tile_any, size=tidx_size, fill_value=n_tiles)[
        0
    ].astype(jnp.int32)
    tcount = jnp.sum(tile_any.astype(jnp.int32))
    n_chunks = (tcount + CT - 1) // CT

    # Loop-invariant tiled views hoisted OUT of the chunk body, and the
    # color accumulator carried in tile-row shape: reshapes at a fori_loop
    # carry boundary materialize as full relayout copies EVERY iteration
    # (the 3.2 ms slice/copy ops that dominated the PT xplane's glue),
    # while the same reshapes outside the loop fuse for free.
    def _tile_view(a):
        k = 1
        for s in a.shape[1:]:
            k *= s
        return a.reshape(n_tiles, TILE * k)

    px_t = px.reshape(n_tiles, TILE)
    py_t = py.reshape(n_tiles, TILE)
    hit0_t = {k: _tile_view(v) for k, v in hit0.items()}

    def tgather_t(at, like, slc):
        return at[slc].reshape((CT * TILE,) + like.shape[1:])

    def chunk_body(ci, carry):
        color_full, n_rays = carry
        sl = jax.lax.dynamic_slice(tidx, (ci * CT,), (CT,))
        tile_ok = sl < n_tiles
        slc = jnp.minimum(sl, n_tiles - 1)
        lane_ok = jnp.repeat(tile_ok, TILE)

        # recompute this chunk's RNG/ray streams from px/py (two u32
        # channels) instead of gathering nine channels of tile views —
        # bit-identical, primary_streams is pure per-pixel math
        c_state, c_o, c_d = primary_streams(
            tgather_t(px_t, px, slc), tgather_t(py_t, py, slc)
        )
        c_hit = {k: tgather_t(hit0_t[k], v, slc) for k, v in hit0.items()}
        # lane reality is positional (global ray index < R0), so it is
        # derived from the tile ids — no gather
        c_lanes = (
            slc[:, None] * TILE
            + jnp.arange(TILE, dtype=jnp.int32)[None, :]
        ).reshape(-1)
        c_active = (c_hit["tri"] >= 0) & lane_ok & (c_lanes < R0)
        c_color = jnp.zeros((CT * TILE, 3), jnp.float32)
        c_thr = jnp.ones((CT * TILE, 3), jnp.float32)
        n_extra = jnp.int32(0)

        def bounce_body(b, bc):
            """One bounce's shade + trace over the chunk's lanes. `b` is a
            PYTHON int (the bounce loop is unrolled — max_bounces is
            static), so the trace-or-not decision and the last round's
            miss are static: no lax.cond staging, and bounce
            max_bounces-1 traces nothing. Every update is masked by the
            lane's `active` flag, so dead lanes keep their result."""
            s, col, thr, act, o_, d_, hit_, n_extra = bc
            (s, col, thr, act, o_, d_, need_shadow) = shade_and_bounce(
                b, s, col, thr, act, o_, d_, hit_
            )
            n_extra = n_extra + jnp.sum(need_shadow.astype(jnp.int32))
            tmax_ = jnp.where(act, jnp.inf, 0.0)
            more = b + 1 < max_bounces
            if not more:
                hit2 = miss_hit_like(hit_, tmax_)
            else:
                hit2 = trace_with_alpha(s, o_, d_, tmax_)
                n_extra = n_extra + jnp.sum(act.astype(jnp.int32))
            if env is not None and more:
                from ..ops.ibl import sample_cubemap

                b_miss = act & (hit2["tri"] < 0)
                sky = thr * sample_cubemap(env, d_)
                sky_contrib = jnp.where(b_miss[..., None], sky, 0.0)
                if clamp_indirect:
                    # every in-chunk trace is bounce >= 1
                    sky_contrib = jnp.clip(sky_contrib, 0.0, 2.0)
                col = col + sky_contrib
            return s, col, thr, act, o_, d_, hit2, n_extra

        # UNROLLED bounce loop (max_bounces is static): a lax.fori_loop
        # here materializes its ~17 MB carry tuple (state/o/d/thr/16-ch
        # hit) at every iteration boundary and forces a lax.cond around
        # the trace; unrolled, XLA fuses across bounces and the last
        # round's trace disappears statically.
        bc = (c_state, c_color, c_thr, c_active, c_o, c_d, c_hit, n_extra)
        for b in range(max_bounces):
            bc = bounce_body(b, bc)
        c_color, n_extra = bc[1], bc[7]

        c_color = jnp.where(lane_ok[..., None], c_color, 0.0)
        color_full = color_full.at[slc].add(c_color.reshape(CT, TILE * 3))
        return color_full, n_rays + n_extra

    with jax.named_scope("wavefront"):
        color_full, n_rays = jax.lax.fori_loop(
            0, n_chunks, chunk_body,
            (color_full.reshape(n_tiles, TILE * 3), n_rays),
        )
    return color_full.reshape(R, 3)[:R0], n_rays


@partial(
    jax.jit,
    static_argnames=(
        "width",
        "height",
        "max_bounces",
        "use_dof",
        "clamp_indirect",
        "return_stats",
        "alpha_rounds",
    ),
)
def pt_render_sample(
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    width: int,
    height: int,
    frame_index,
    max_bounces: int = 3,
    use_dof: bool = False,
    clamp_indirect: bool = False,
    return_stats: bool = False,
    env: jnp.ndarray | None = None,
    alpha_rounds: int = 0,
):
    """One full-frame 1-spp sample pass -> (H*W, 3) linear color in
    row-major pixel order (+ ray count when return_stats)."""
    px = jnp.tile(jnp.arange(width, dtype=jnp.uint32), height)
    py = jnp.repeat(jnp.arange(height, dtype=jnp.uint32), width)
    color, n_rays = pt_trace_pixels(
        static_scene,
        frame,
        arena,
        cam,
        px,
        py,
        jnp.array([width, height], jnp.int32),
        frame_index,
        max_bounces,
        use_dof,
        clamp_indirect,
        env,
        alpha_rounds,
    )
    if return_stats:
        return color, n_rays
    return color


def pt_accumulate(prev_color, prev_count, sample):
    """Running-mean accumulation (main.rgen:284-297)."""
    count = prev_count + 1.0
    new_color = prev_color + (sample - prev_color) / count[..., None]
    return new_color, count


@partial(jax.jit, static_argnames=("width", "height"))
def _accum_tonemap(prev_color, prev_count, sample_flat, lut, exposure,
                   contrast, *, width, height):
    """Jitted frame tail: accumulate + tonemap in ONE dispatch.

    An eager per-frame tail is ~50 host dispatches per frame, and the
    eager chain serializes frame i+1's dispatch behind frame i's tail.
    The sample render takes no state, so with the tail fused the next
    frame's render overlaps this frame's accumulation."""
    with jax.named_scope("accumulate"):
        sample = sample_flat.reshape(height, width, 3)
        color, count = pt_accumulate(prev_color, prev_count, sample)
    with jax.named_scope("tonemap"):
        img = tone_map(color, lut, exposure, contrast)
    return img, color, count


def pt_entry(
    *,
    static,
    frame,
    arena,
    cam,
    lut,
    width,
    height,
    exposure=1.0,
    contrast=1.0,
    max_bounces=3,
    frame_index=0,
    state=None,
    accumulate=True,
    env=None,
    alpha_rounds=0,
    **_,
):
    """CLI-facing PT mode: renders one sample, accumulates, tonemaps."""
    from ..utils.profiler import profiled_jit_call

    sample = profiled_jit_call(
        pt_render_sample,
        static, frame, arena, cam, width, height, frame_index, max_bounces,
        env=env, alpha_rounds=alpha_rounds,
    )
    if state is None or not accumulate:
        img, color, count = profiled_jit_call(
            _accum_tonemap,
            jnp.zeros((height, width, 3), jnp.float32),
            jnp.zeros((height, width), jnp.float32),
            sample, lut, exposure, contrast, width=width, height=height,
        )
    else:
        img, color, count = profiled_jit_call(
            _accum_tonemap,
            state[0], state[1], sample, lut, exposure, contrast,
            width=width, height=height,
        )
    return img, (color, count)
