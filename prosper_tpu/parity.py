"""Parity checks between the renderer's implementations: the golden-frame
recipe the CPU tests pin, the frame comparison a GPU run is held to, and
the ray sets and statistics that compare the CUDA tracer with the plain
XLA tracer. chip_smoke.py calls these on the card; tests/test_goldens.py
and tests/test_gpu_parity.py wrap them.
"""

from __future__ import annotations

import numpy as np

GOLDEN_RES = 256
GOLDEN_MODES = ("forward", "pt", "deferred", "restir")
# a GPU frame against the CPU golden, after tone mapping
FRAME_TOL = {"mean_abs": 1.0 / 255.0, "within_2": 0.99}
# CUDA tracer against the plain tracer, per ray set
TRACER_TOL = {
    "hit_agree": 0.9999,
    "tri_agree": 0.999,
    "dt_rel": 1e-4,  # |dt| <= dt_rel * max(t, 1) on every ray both hit
    "any_agree": 0.9999,
}


def _device_tree(tree: dict) -> dict:
    import jax.numpy as jnp

    return {
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in tree.items()
        if k not in ("scene_camera", "bvh_depth")
    }


def load_scene(size: str = "small", width: int = GOLDEN_RES,
               height: int = GOLDEN_RES, scatter_lights: int = 0,
               max_texture_dim: int = 2048) -> dict:
    """The seeded scene on the device: static, frame, arena, cam, lut.
    scatter_lights > 0 scatters that many point lights like the CLI's
    --scatter-lights (seed 0)."""
    import jax.numpy as jnp

    from .ops.texture import pack_material_tables
    from .ops.tonemap import generated_lut
    from .scene.textures import build_texture_arena
    from .scene.world import World
    from .testing import seeded_scene_path

    world = World(seeded_scene_path(size), use_cache=False)
    if scatter_lights:
        rng = np.random.default_rng(0)
        n = min(scatter_lights, 1024)
        lo = world.wc_aabb_min_obj.min(axis=0)
        hi = world.wc_aabb_max_obj.max(axis=0)
        world.lights.point_position[:n] = rng.uniform(lo, hi, (n, 3))
        world.lights.point_radiance[:n] = rng.uniform(0.05, 0.5, (n, 3))
        world.lights.point_radius[:n] = float(np.linalg.norm(hi - lo))
        world.lights.point_count = n
    arena = build_texture_arena(world.doc, max_dim=max_texture_dim)
    static = _device_tree(world.static_scene_arrays())
    arena_dev = {k: jnp.asarray(v) for k, v in arena.uniforms().items()}
    arena_dev["mat_f32"], arena_dev["mat_i32"] = pack_material_tables(
        world.static_scene_arrays()["materials"], arena_dev
    )
    cam = {
        k: jnp.asarray(v)
        for k, v in world.make_camera((width, height)).uniforms().items()
    }
    return {
        "world": world,
        "static": static,
        "frame": _device_tree(world.frame_arrays(0.0)),
        "arena": arena_dev,
        "cam": cam,
        "lut": jnp.asarray(generated_lut()),
        "width": width,
        "height": height,
    }


def golden_frame(mode: str, scene: dict | None = None) -> np.ndarray:
    """The golden recipe of `mode` on the small seeded scene at
    GOLDEN_RES^2: (H, W, 3) tone-mapped display values."""
    from .render.deferred import deferred_entry
    from .render.forward import render_forward
    from .render.pt import pt_entry
    from .render.restir import restir_entry

    s = scene or load_scene()
    kw = dict(static=s["static"], frame=s["frame"], arena=s["arena"],
              cam=s["cam"], lut=s["lut"], width=s["width"],
              height=s["height"])
    if mode == "forward":
        img = render_forward(s["static"], s["frame"], s["arena"], s["cam"],
                             s["lut"], s["width"], s["height"])
    elif mode == "pt":
        img, _ = pt_entry(max_bounces=2, frame_index=0, **kw)
    elif mode == "deferred":
        img, _ = deferred_entry(use_bloom=True, use_dof=True, **kw)
    elif mode == "restir":
        img, _ = restir_entry(frame_index=0, **kw)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return np.asarray(img, np.float32)


def frame_parity(img: np.ndarray, ref: np.ndarray) -> dict:
    """Mean abs difference and the share of pixels whose every channel is
    within 2/255, of two tone-mapped frames."""
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32))
    return {
        "mean_abs": float(diff.mean()),
        "within_2": float((diff.max(axis=-1) <= 2.0 / 255.0).mean()),
    }


def frame_parity_ok(stats: dict) -> bool:
    return (stats["mean_abs"] <= FRAME_TOL["mean_abs"]
            and stats["within_2"] >= FRAME_TOL["within_2"])


def ray_sets(scene: dict, n_lights: int = 1024, seed: int = 0) -> dict:
    """The three ray sets the tracers are compared and timed on, built
    with the plain tracer so both tracers see the same rays:
    - primary: one ray through every pixel center;
    - bounce: one cosine-hemisphere ray from each primary hit;
    - shadow: from each primary hit toward one of n_lights scattered
      point lights (the ReSTIR shadow batch; t_min 0.1 like it).
    Each entry is (o, d, t_min, t_max); rays without a primary hit carry
    t_max = 0."""
    import jax
    import jax.numpy as jnp

    from .ops import trace
    from .ops.brdf import cosine_sample_hemisphere
    from .ops.rays import offset_ray, pinhole_rays

    w, h = scene["width"], scene["height"]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = np.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1).reshape(-1, 2)
    o, d = pinhole_rays(scene["cam"], jnp.asarray(uv, jnp.float32))
    tris = trace.frame_geometry(scene["static"], scene["frame"])["tris"]
    wmin = scene["frame"]["wc_aabb_min_w"]
    wmax = scene["frame"]["wc_aabb_max_w"]
    hit = trace.trace_closest(tris, wmin, wmax, o, d, 1e-4, jnp.inf)

    valid = hit["tri"] >= 0
    tri = jnp.maximum(hit["tri"], 0)
    n = jnp.cross(tris["e1"][tri], tris["e2"][tri])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    n = jnp.where((jnp.sum(n * d, -1) > 0)[:, None], -n, n)
    p = o + jnp.where(valid, hit["t"], 0.0)[:, None] * d
    origin = offset_ray(p, n)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    bd = cosine_sample_hemisphere(n, jax.random.uniform(k1, (o.shape[0], 2)))

    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(wmin).min(0), np.asarray(wmax).max(0)
    lights = jnp.asarray(rng.uniform(lo, hi, (n_lights, 3)), jnp.float32)
    pick = jax.random.randint(k2, (o.shape[0],), 0, n_lights)
    to_l = lights[pick] - origin
    dist = jnp.linalg.norm(to_l, axis=-1)
    sd = to_l / jnp.maximum(dist, 1e-20)[:, None]
    off = jnp.where(valid, jnp.inf, 0.0)
    return {
        "primary": (o, d, 1e-4, jnp.full((o.shape[0],), jnp.inf)),
        "bounce": (origin, bd, 1e-4, off),
        "shadow": (origin, sd, 0.1, jnp.where(valid, dist, 0.0)),
    }


def tracer_parity(scene: dict, rays: dict) -> dict:
    """Per ray set: hit/miss agreement, same-triangle share of common
    hits, worst |dt| / max(t, 1) over common hits, any-hit agreement —
    the CUDA tracer against the plain tracer."""
    import jax

    from .ops import trace, trace_cuda

    static, frame = scene["static"], scene["frame"]
    tris = trace.frame_geometry(static, frame)["tris"]
    bvh = trace.frame_bvh(frame)
    cuda_args = (tris, static["wc_tri_count"], bvh[0], bvh[1])
    plain_args = (tris, frame["wc_aabb_min_w"], frame["wc_aabb_max_w"])
    out = {}
    for name, (o, d, t_min, t_max) in rays.items():
        a = jax.device_get(trace_cuda.trace_closest_cuda(
            *cuda_args, o, d, t_min, t_max))
        b = jax.device_get(trace.trace_closest(*plain_args, o, d, t_min,
                                               t_max))
        occ_a = np.asarray(trace_cuda.trace_any_cuda(
            *cuda_args, o, d, t_min, t_max))
        occ_b = np.asarray(trace.trace_any(*plain_args, o, d, t_min, t_max))
        ha, hb = a["tri"] >= 0, b["tri"] >= 0
        both = ha & hb
        dt = np.abs(a["t"][both] - b["t"][both]) / np.maximum(
            np.abs(b["t"][both]), 1.0)
        out[name] = {
            "rays": int(ha.shape[0]),
            "hits": int(hb.sum()),
            "hit_agree": float((ha == hb).mean()),
            "tri_agree": float((a["tri"][both] == b["tri"][both]).mean())
            if both.any() else 1.0,
            "dt_rel_max": float(dt.max()) if both.any() else 0.0,
            "dt_violations": int((dt > TRACER_TOL["dt_rel"]).sum()),
            "any_agree": float((occ_a == occ_b).mean()),
        }
        if both.any():
            out[name]["worst"] = _worst_ray(tris, o, d, a, b, both, dt)
    return out


def _worst_ray(tris, o, d, a, b, both, dt) -> dict:
    """The ray with the largest |dt|: both t, whether the two tracers
    picked the same triangle, and |cos| between the ray and that
    triangle's plane normal (grazing hits amplify rounding in t)."""
    k = int(np.flatnonzero(both)[np.argmax(dt)])
    tri = int(b["tri"][k])
    e1 = np.asarray(tris["e1"][tri], np.float64)
    e2 = np.asarray(tris["e2"][tri], np.float64)
    n = np.cross(e1, e2)
    dk = np.asarray(d[k], np.float64)
    cos = abs(n @ dk) / max(np.linalg.norm(n) * np.linalg.norm(dk), 1e-30)
    return {"t_cuda": float(a["t"][k]), "t_plain": float(b["t"][k]),
            "same_tri": bool(a["tri"][k] == tri), "cos": float(cos)}


def tracer_parity_ok(stats: dict) -> bool:
    return all(
        s["hit_agree"] >= TRACER_TOL["hit_agree"]
        and s["tri_agree"] >= TRACER_TOL["tri_agree"]
        and s["dt_violations"] == 0
        and s["any_agree"] >= TRACER_TOL["any_agree"]
        for s in stats.values()
    )
