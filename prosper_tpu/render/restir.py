"""ReSTIR DI: initial reservoirs -> biased spatial reuse -> traced shading.

Parity with /root/reference/res/shader/restir_di/ and
rt/direct_illumination/main.rgen (Wyman et al. course-notes formulation):
- InitialReservoirs: 5 uniform light candidates, streaming RIS with
  misWeight 1/M and UCW = lightCount; reservoir = {lightIndex, W}
  (initial_reservoirs.comp:31-60)
- SpatialReuse (biased): 5 samples in a 30px disk, <=5 rejection tries
  each; 10% linear-depth and 25deg (dot 0.9) normal heuristics; MIS
  weight 1/validSampleCount (spatial_reuse.comp:33-137)
- Trace: shadow ray on the winning sample x unbiasedContributionWeight,
  running-mean accumulation (main.rgen:87-161)
- Every pass reseeds pcg_state = (px, py, frameIndex) like the separate
  GLSL dispatches; data-dependent RNG advances (the rejection loop, the
  valid-sample-only resampling) are reproduced with per-pixel masked
  state advances.

pHat = luminance(irradiance * BRDF * NoL) without visibility
(resampling_phat.glsl).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..mathx import rng as prng
from ..mathx.color import luminance
from ..mathx.packing import signed_oct_decode
from ..ops import trace
from ..ops.brdf import eval_brdf_times_nol
from ..ops.tonemap import tone_map
from .shading import sample_light

INITIAL_CANDIDATES = 5
SPATIAL_SAMPLES = 5
SPATIAL_RADIUS = 30.0
MAX_TRIES = 5


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _p_hat(surface: dict, lights: dict, light_index: jnp.ndarray):
    l, _, irr = sample_light(lights, light_index, surface["position_ws"])
    brdf = eval_brdf_times_nol(
        l,
        surface["inv_view_ray"],
        surface["normal_ws"],
        surface["albedo"],
        surface["roughness"],
        surface["metallic"],
    )
    return luminance(irr * brdf)


def initial_reservoirs(surface: dict, lights: dict, px, py, frame_index):
    """(R,) light index (-1 invalid) + (R,) UCW."""
    state = prng.make_state(px, py, jnp.uint32(frame_index))
    light_count = (1 + lights["point_count"] + lights["spot_count"]).astype(
        jnp.float32
    )
    R = px.shape[0]
    res_light = jnp.full((R,), -1, jnp.int32)
    sum_w = jnp.zeros((R,), jnp.float32)

    mis = 1.0 / INITIAL_CANDIDATES
    res_phat = jnp.zeros((R,), jnp.float32)
    for _ in range(INITIAL_CANDIDATES):
        state, u = prng.rnd01(state)
        li = jnp.minimum(
            (u * light_count).astype(jnp.int32),
            (light_count - 1.0).astype(jnp.int32),
        )
        phat = _p_hat(surface, lights, li)
        w = mis * phat * light_count
        sum_w = sum_w + w
        state, accept_u = prng.rnd01(state)
        accept = accept_u < w / jnp.where(sum_w > 0, sum_w, 1.0)
        res_light = jnp.where(accept, li, res_light)
        # carry the accepted candidate's pHat: recomputing it after the
        # loop costs another light gather + BRDF pass over every pixel
        res_phat = jnp.where(accept, phat, res_phat)

    ucw = jnp.where(
        res_light >= 0,
        sum_w / jnp.maximum(res_phat, 1e-20),
        0.0,
    )
    return res_light, ucw


def _uniform_sample_disk(u):
    """sampling.glsl:8-13."""
    r = jnp.sqrt(u[..., 0])
    theta = 2.0 * np.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def pack_neighbor_rows(gbuf: dict, res_light, res_ucw):
    """ONE packed row per pixel for the spatial rejection loop: depth +
    oct normal + reservoir ride in a single (R, 8) gather instead of
    four. Full-size (neighbors may live outside the compacted tiles)."""
    R = res_light.shape[0]
    return jnp.concatenate(
        [
            gbuf["linear_depth"][..., None],
            gbuf["normal_metallic"][..., :3],
            res_light.astype(jnp.float32)[..., None],
            res_ucw[..., None],
            jnp.zeros((R, 2), jnp.float32),
        ],
        axis=-1,
    )


def spatial_reuse(
    surface: dict,
    lights: dict,
    neigh_rows: jnp.ndarray,
    px,
    py,
    width: int,
    height: int,
    frame_index,
    neigh_y0=0,
    neigh_rows_h: int | None = None,
):
    """Biased spatial reuse (spatial_reuse.comp). `neigh_rows` is the
    pack_neighbor_rows image covering rows [neigh_y0, neigh_y0 +
    neigh_rows_h) of the frame (the full frame by default; a band+halo
    slab under multi-chip sharding — render/distributed.py). Everything
    else may be a tile-compacted chunk. px/py/width/height are always
    absolute frame coordinates (the RNG streams and edge rejection
    depend on them)."""
    state = prng.make_state(px, py, jnp.uint32(frame_index))
    R = px.shape[0]

    lin_depth = surface["linear_depth"]
    normal = surface["normal_ws"]

    def try_body(_k, carry):
        state, found, s_li, s_ucw = carry
        trying = ~found
        state_n, u2 = prng.rnd2d01(state)
        state = jnp.where(trying[..., None], state_n, state)
        r = (
            _uniform_sample_disk(u2) * SPATIAL_RADIUS * 2.0 - SPATIAL_RADIUS
        ).astype(jnp.int32)
        p_x = px.astype(jnp.int32) + r[..., 0]
        p_y = py.astype(jnp.int32) + r[..., 1]
        # `any(lessThanEqual(p, 0)) || any(greaterThanEqual(p, res))`
        in_bounds = (p_x > 0) & (p_y > 0) & (p_x < width) & (p_y < height)
        rows_h = height if neigh_rows_h is None else neigh_rows_h
        p_flat = jnp.clip(p_y - neigh_y0, 0, rows_h - 1) * width + jnp.clip(
            p_x, 0, width - 1
        )
        row = neigh_rows[p_flat]  # (R, 8) one gather per try
        nd = row[..., 0]
        depth_ok = (
            jnp.abs(1.0 - nd / jnp.where(lin_depth != 0, lin_depth, 1.0))
            <= 0.1
        )
        nrm_ok = _dot(signed_oct_decode(row[..., 1:4]), normal) >= 0.9
        ok = trying & in_bounds & depth_ok & nrm_ok
        s_li = jnp.where(ok, row[..., 4].astype(jnp.int32), s_li)
        s_ucw = jnp.where(ok, row[..., 5], s_ucw)
        found = found | ok
        return (state, found, s_li, s_ucw)

    samples_li = []
    samples_ucw = []
    samples_found = []
    for _i in range(SPATIAL_SAMPLES):
        state, found, s_li, s_ucw = jax.lax.fori_loop(
            0,
            MAX_TRIES,
            try_body,
            (
                state,
                jnp.zeros((R,), bool),
                jnp.full((R,), -1, jnp.int32),
                jnp.zeros((R,), jnp.float32),
            ),
        )
        samples_li.append(jnp.where(found, s_li, -1))
        samples_ucw.append(jnp.where(found, s_ucw, 0.0))
        samples_found.append(found)

    # validSampleCount counts every neighbor that passed the depth/normal
    # heuristics, even when its reservoir is empty (lightIndex -1) —
    # spatial_reuse.comp increments before inspecting the reservoir.
    valid_count = sum(f.astype(jnp.float32) for f in samples_found)

    out_light = jnp.full((R,), -1, jnp.int32)
    out_phat = jnp.zeros((R,), jnp.float32)
    sum_w = jnp.zeros((R,), jnp.float32)
    for li, ucw in zip(samples_li, samples_ucw):
        valid = li >= 0
        phat = _p_hat(surface, lights, jnp.maximum(li, 0))
        w = jnp.where(valid, phat * ucw, 0.0)
        sum_w = sum_w + w
        # GLSL consumes rnd01 only for valid samples (continue skips it)
        state_n, u = prng.rnd01(state)
        state = jnp.where(valid[..., None], state_n, state)
        accept = valid & (u < w / jnp.where(sum_w > 0, sum_w, 1.0))
        out_light = jnp.where(accept, li, out_light)
        out_phat = jnp.where(accept, phat, out_phat)  # avoid a recompute

    out_ucw = jnp.where(
        out_light >= 0,
        (1.0 / jnp.maximum(valid_count, 1.0))
        * sum_w
        / jnp.maximum(out_phat, 1e-20),
        0.0,
    )
    return out_light, out_ucw


def restir_shade(
    surface: dict,
    lights: dict,
    res_light: jnp.ndarray,
    res_ucw: jnp.ndarray,
    tracer,
):
    """Traced final shading (main.rgen evaluateDirectLightingReSTIR)."""
    li = jnp.maximum(res_light, 0)
    l, dist, irr = sample_light(lights, li, surface["position_ws"])
    front = _dot(l, surface["normal_ws"]) > 0.0
    valid = (res_light >= 0) & front & surface["valid"] & (surface["alpha"] != 0.0)

    shadow_o = jnp.where(valid[..., None], surface["position_ws"], 0.0)
    shadow_d = jnp.where(valid[..., None], l, jnp.array([0.0, 0.0, 1.0]))
    shadow_tmax = jnp.where(valid, dist, 0.0)
    occluded = tracer.any(shadow_o, shadow_d, 0.1, shadow_tmax)
    vis = jnp.where(valid & ~occluded, 1.0, 0.0)
    color = (
        irr
        * vis[..., None]
        * eval_brdf_times_nol(
            l,
            surface["inv_view_ray"],
            surface["normal_ws"],
            surface["albedo"],
            surface["roughness"],
            surface["metallic"],
        )
        * res_ucw[..., None]
    )
    return jnp.where(valid[..., None], color, 0.0)


@partial(jax.jit, static_argnames=("width", "height", "alpha_rounds", "tone"))
def render_restir(
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    lut: jnp.ndarray,
    width: int,
    height: int,
    frame_index,
    exposure: float = 1.0,
    contrast: float = 1.0,
    alpha_rounds: int = 0,
    tone: bool = True,
):
    """Full ReSTIR DI frame: G-buffer -> reservoirs -> spatial -> trace."""
    from .gbuffer import render_gbuffer

    # named pass scopes: per-pass device attribution via
    # utils/profiler.profile_passes (Profiler.hpp:19-327 analog)
    with jax.named_scope("gbuffer"):
        gbuf = render_gbuffer(
            static_scene, frame, arena, cam, width, height,
            alpha_rounds=alpha_rounds,
        )
    surface = dict(gbuf["surface"])
    # linear depth from the non-linear buffer like the comp shaders
    c2c = cam["camera_to_clip"]
    lin = -c2c[2, 3] / (gbuf["depth"] + c2c[2, 2])
    surface["linear_depth"] = lin
    gbuf2 = dict(gbuf)
    gbuf2["linear_depth"] = lin

    px = jnp.tile(jnp.arange(width, dtype=jnp.uint32), height)
    py = jnp.repeat(jnp.arange(height, dtype=jnp.uint32), width)
    lights = frame["lights"]
    tracer = trace.make_tracer(static_scene, frame)

    # All three ReSTIR stages run tile-compacted on the G-buffer's valid
    # mask (ops/compact.tile_apply): the 5-candidate RIS light gathers,
    # the 5x5 spatial rejection-loop neighbor gathers and the final
    # traced shading only touch 256-pixel tiles containing geometry. The
    # spatial pass still READS neighbor reservoirs from the full-size
    # packed image, so cross-tile reuse is unchanged; empty-tile pixels
    # keep lightIndex -1 exactly like the dense pass (per-pixel RNG
    # streams ride the compaction -> bit-identical results).
    from ..ops.compact import tile_apply

    valid = gbuf["valid"]
    pad = (-px.shape[0]) % 256

    def _pad(a):
        return (
            jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
            if pad
            else a
        )

    surface_p = {k: _pad(v) for k, v in surface.items()}
    in_p = (surface_p, _pad(px), _pad(py))
    valid_p = _pad(valid)

    def _initial(c_in, lane_ok):
        c_surface, c_px, c_py = c_in
        li, ucw = initial_reservoirs(c_surface, lights, c_px, c_py, frame_index)
        return {"li": jnp.where(lane_ok, li, -1), "ucw": ucw}

    with jax.named_scope("ris_initial"):
        r0 = tile_apply(valid_p, _initial, in_p)
        li0 = jnp.where(valid_p, r0["li"], -1)[: px.shape[0]]
        ucw0 = r0["ucw"][: px.shape[0]]
        neigh_rows = pack_neighbor_rows(gbuf2, li0, ucw0)

    def _spatial_shade(c_in, lane_ok):
        c_surface, c_px, c_py = c_in
        li1, ucw1 = spatial_reuse(
            c_surface, lights, neigh_rows, c_px, c_py,
            width, height, frame_index,
        )
        c_surface = dict(c_surface)
        c_surface["valid"] = lane_ok
        color = restir_shade(c_surface, lights, li1, ucw1, tracer)
        return color

    with jax.named_scope("spatial_shade"):
        color = tile_apply(valid_p, _spatial_shade, in_p)[: px.shape[0]]
    # tone=False when the caller fuses accumulation+tonemap into its own
    # jitted tail (_accum_tonemap): the internal tone_map would be dead
    # work XLA cannot DCE across the jit boundary.
    if not tone:
        return None, color
    with jax.named_scope("tonemap"):
        img = tone_map(
            color.reshape(height, width, 3), lut, exposure, contrast
        )
    return img, color


def restir_entry(
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
    frame_index=0,
    state=None,
    **kw,
):
    from ..utils.profiler import profiled_jit_call

    img, color = profiled_jit_call(
        render_restir,
        static, frame, arena, cam, lut, width, height, frame_index,
        exposure, contrast, alpha_rounds=kw.get("alpha_rounds", 0),
        tone=state is None,
    )
    # Running-mean accumulation like the reference trace pass, fused
    # into ONE jitted dispatch (render/pt._accum_tonemap): an eager tail
    # is dozens of host dispatches per frame and serializes the next
    # frame's dispatch behind it.
    if state is None:
        acc, count = (
            color.reshape(height, width, 3),
            jnp.ones((height, width), jnp.float32),
        )
    else:
        from .pt import _accum_tonemap

        img, acc, count = profiled_jit_call(
            _accum_tonemap,
            state[0], state[1], color, lut, exposure, contrast,
            width=width, height=height,
        )
    return img, (acc, count)
