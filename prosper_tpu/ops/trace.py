"""Closest-hit / any-hit ray tracing over the flattened cluster scene,
and the one place that picks the tracer for the platform.

Two tracers share one contract (`Tracer.closest` -> dict t, tri, u, v;
`Tracer.any` -> (R,) bool occluded; both take rays (o, d), t_min, t_max
and an optional per-cluster mask of clusters to trace):

- the plain XLA tracer below (`trace_closest` / `trace_any`): rays in
  TILE-ray packets, a conservative packet-vs-cluster-AABB cull gives
  each packet a cluster list, and each listed 128-triangle cluster slab
  is intersected densely. It runs on the CPU and is the reference the
  other tracer is tested against;
- the CUDA BVH tracer (ops/trace_cuda.py): one thread per ray walks the
  per-frame cluster BVH with an ordered stack, on NVIDIA Hopper.

`tracer_kind` is the only platform decision in the renderer: every
render pass asks `make_tracer`, which asks it.

Replaces: VK ray tracing pipeline + BLAS/TLAS traversal
(RtReference.cpp:301-527, TLAS rebuild World.cpp:749-802 in the
reference).
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .intersect import exact_hit_t, moller_trumbore, packet_aabb_overlap

TILE = 256  # rays per packet of the plain tracer
CLUSTER_PAD = 128  # triangles per cluster slab (scene/meshlets.py)

# The measured winner on each platform (PERF.md, "ray tracer").
_TRACER_BY_PLATFORM = {"cpu": "plain", "gpu": "cuda"}
_forced: str | None = None


def tracer_kind(platform: str | None = None) -> str:
    """"plain" or "cuda": the tracer for `platform` (default: the platform
    JAX computes on). The single platform decision of the renderer; any
    platform without a tracer raises."""
    if _forced is not None:
        return _forced
    if platform is None:
        platform = jax.default_backend()
    try:
        return _TRACER_BY_PLATFORM[platform]
    except KeyError:
        raise ValueError(
            f"no ray tracer for platform {platform!r} "
            f"(supported: {sorted(_TRACER_BY_PLATFORM)})"
        ) from None


@contextlib.contextmanager
def forced_tracer(kind: str):
    """Trace every pass with `kind` inside the block (parity checks run
    the plain tracer on the GPU). Clears JAX's caches on entry and exit
    so jitted frames are re-staged with the forced tracer."""
    global _forced
    if kind not in _TRACER_BY_PLATFORM.values():
        raise ValueError(f"unknown tracer {kind!r}")
    prev = _forced
    jax.clear_caches()
    _forced = kind
    try:
        yield
    finally:
        _forced = prev
        jax.clear_caches()


class Tracer(NamedTuple):
    """closest(o, d, t_min, t_max, cluster_mask=None) -> hit dict;
    any(o, d, t_min, t_max, cluster_mask=None) -> (R,) bool."""

    closest: Callable
    any: Callable


def masked_aabbs(wc_min, wc_max, mask):
    """Inverted (empty) AABBs for clusters outside `mask`: the plain
    tracer's packet cull then never visits them (the draw-list analog)."""
    big = jnp.float32(3e38)
    return (
        jnp.where(mask[:, None], wc_min, big),
        jnp.where(mask[:, None], wc_max, -big),
    )


def make_tracer(static_scene: dict, frame: dict) -> Tracer:
    """The tracer for this frame's geometry on the current platform.

    cluster_mask (C,) bool selects the clusters a trace may hit (two-phase
    culling, the transparent pass's blend-only trace): the plain tracer
    folds it into inverted AABBs, the CUDA tracer skips masked leaves."""
    tris = frame_geometry(static_scene, frame)["tris"]
    wc_min, wc_max = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    if tracer_kind() == "plain":

        def _plain(fn, o, d, t_min, t_max, cluster_mask=None):
            mn, mx = wc_min, wc_max
            if cluster_mask is not None:
                mn, mx = masked_aabbs(mn, mx, cluster_mask)
            return fn(tris, mn, mx, o, d, t_min, t_max)

        return Tracer(partial(_plain, trace_closest), partial(_plain, trace_any))

    from . import trace_cuda

    bvh = frame_bvh(frame)
    assert bvh is not None, "the CUDA tracer needs the frame's BVH"
    args = (tris, static_scene["wc_tri_count"], bvh[0], bvh[1])
    return Tracer(
        partial(trace_cuda.trace_closest_cuda, *args),
        partial(trace_cuda.trace_any_cuda, *args),
    )


def prepare_geometry(static_scene: dict, transforms, normal_transforms):
    """Device-side world-space geometry prep, hoisted OUT of the frame jits.

    Re-transforming every triangle inside each frame's jit is a full BLAS
    refit per frame; the reference builds BLAS device data once and only
    rebuilds the instance-level TLAS per frame (World.cpp:749-802).
    Callers stash the result at frame["geom"] (see GeometryCache for the
    recompute-on-transform-change pacing); frame_geometry() falls back to
    inline computation when absent.

    Returns {"tris": world-space tri dict}.
    """
    frame_like = {
        "transforms": transforms,
        "normal_transforms": normal_transforms,
    }
    return {"tris": world_triangles(static_scene, frame_like)}


def frame_geometry(static_scene: dict, frame: dict) -> dict:
    """frame["geom"] when the caller prepared it, else the inline
    equivalent (tests that build raw frame dicts keep working)."""
    geom = frame.get("geom")
    if geom is not None:
        return geom
    return prepare_geometry(
        static_scene, frame["transforms"], frame["normal_transforms"]
    )


class GeometryCache:
    """Host-side pacing for prepare_geometry: recompute only when the
    instance transforms change (animation), reuse the device arrays
    otherwise — the analog of static BLAS + per-frame TLAS.
    """

    def __init__(self):
        self._jit = jax.jit(prepare_geometry)
        self._key = None
        self._val = None

    def get(self, static_dev: dict, transforms, normal_transforms) -> dict:
        import numpy as np

        key = (
            np.asarray(transforms).tobytes(),
            np.asarray(normal_transforms).tobytes(),
        )
        if self._val is None or key != self._key:
            self._val = self._jit(
                static_dev,
                jnp.asarray(transforms),
                jnp.asarray(normal_transforms),
            )
            self._key = key
        return self._val


def frame_bvh(frame: dict):
    """(bounds, meta) from a frame dict, or None when absent."""
    if "bvh_bounds" in frame and "bvh_meta" in frame:
        return frame["bvh_bounds"], frame["bvh_meta"]
    return None


def _pad_rays(ray_o, ray_d):
    """Pad ray count to a TILE multiple with miss-guaranteed dummy rays.

    Dummy rays keep the origin of ray 0 (so packet origin bounds stay
    tight) with a zero direction, which can never pass the slab/Möller
    tests. Returns (o, d, original_count)."""
    R = ray_o.shape[0]
    pad = (-R) % TILE
    if pad == 0:
        return ray_o, ray_d, R
    o_pad = jnp.broadcast_to(ray_o[:1], (pad, 3))
    d_pad = jnp.zeros((pad, 3), ray_d.dtype)
    return (
        jnp.concatenate([ray_o, o_pad], axis=0),
        jnp.concatenate([ray_d, d_pad], axis=0),
        R,
    )


def world_triangles(static_scene: dict, frame: dict) -> dict:
    """Transform object-space cluster tris to world space (device, fused).

    The per-frame analog of the TLAS rebuild: one batched affine transform
    over the whole arena, gathering each triangle's instance matrix.
    """
    m = frame["transforms"]  # (I, 3, 4)
    inst = static_scene["wt_instance"]  # (S,)
    mi = m[inst]  # (S, 3, 4) gather

    def xf(p):
        return jnp.einsum("sij,sj->si", mi[:, :, :3], p) + mi[:, :, 3]

    p0 = xf(static_scene["wt_p0"])
    p1 = xf(static_scene["wt_p1"])
    p2 = xf(static_scene["wt_p2"])
    return {"v0": p0, "e1": p1 - p0, "e2": p2 - p0}


@partial(jax.jit, static_argnames=("max_clusters",))
def trace_closest(
    tris: dict,
    wc_min: jnp.ndarray,
    wc_max: jnp.ndarray,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    t_min,
    t_max,
    max_clusters: int | None = None,
):
    """Closest hit for R rays (R multiple of TILE).

    Returns dict: t (R,), tri (R,) int32 slot index (-1 = miss),
    u, v (R,) barycentrics.
    """
    n_clusters = wc_min.shape[0]
    max_clusters = max_clusters or n_clusters
    t_max_full = jnp.broadcast_to(
        jnp.asarray(t_max, jnp.float32), (ray_o.shape[0],)
    )
    ray_o, ray_d, R_out = _pad_rays(ray_o, ray_d)
    R = ray_o.shape[0]
    n_tiles = R // TILE
    o_t = ray_o.reshape(n_tiles, TILE, 3)
    d_t = ray_d.reshape(n_tiles, TILE, 3)
    t_max_t = jnp.concatenate(
        [t_max_full, jnp.zeros((R - R_out,), jnp.float32)]
    ).reshape(n_tiles, TILE)
    t_min = jnp.asarray(t_min, jnp.float32)

    # ---- phase 1: conservative packet cull -> per-tile cluster lists ----
    o_lo, o_hi = o_t.min(axis=1), o_t.max(axis=1)
    d_lo, d_hi = d_t.min(axis=1), d_t.max(axis=1)
    overlap = packet_aabb_overlap(
        o_lo[:, None, :],
        o_hi[:, None, :],
        d_lo[:, None, :],
        d_hi[:, None, :],
        wc_min[None, :, :],
        wc_max[None, :, :],
        t_max_t.max(axis=1)[:, None],
    )  # (T, C)
    counts = overlap.sum(axis=1).astype(jnp.int32)  # (T,)
    # stable-compact overlapping cluster ids to the front
    order = jnp.argsort(~overlap, axis=1, stable=True)  # (T, C)
    lists = order[:, :max_clusters].astype(jnp.int32)
    counts = jnp.minimum(counts, max_clusters)

    v0, e1, e2 = tris["v0"], tris["e1"], tris["e2"]

    # ---- phase 2: per-tile dense slab intersection ----
    def tile_trace(o, d, tmax0, clist, count):
        def cond(state):
            k = state[0]
            return k < count

        def body(state):
            k, best_t, best_tri, best_u, best_v = state
            c = clist[k]
            base = c * CLUSTER_PAD
            tv0 = jax.lax.dynamic_slice(v0, (base, 0), (CLUSTER_PAD, 3))
            te1 = jax.lax.dynamic_slice(e1, (base, 0), (CLUSTER_PAD, 3))
            te2 = jax.lax.dynamic_slice(e2, (base, 0), (CLUSTER_PAD, 3))
            hit, t, u, v = moller_trumbore(
                o[:, None, :],
                d[:, None, :],
                tv0[None, :, :],
                te1[None, :, :],
                te2[None, :, :],
                t_min,
                best_t[:, None],
            )  # (TILE, 128)
            t = jnp.where(hit, t, jnp.inf)
            j = jnp.argmin(t, axis=1)  # (TILE,)
            tj = jnp.take_along_axis(t, j[:, None], axis=1)[:, 0]
            better = tj < best_t
            sel = lambda new, old: jnp.where(better, new, old)
            best_tri = sel(base + j.astype(jnp.int32), best_tri)
            best_u = sel(jnp.take_along_axis(u, j[:, None], 1)[:, 0], best_u)
            best_v = sel(jnp.take_along_axis(v, j[:, None], 1)[:, 0], best_v)
            best_t = sel(tj, best_t)
            return (k + 1, best_t, best_tri, best_u, best_v)

        init = (
            jnp.int32(0),
            tmax0,
            jnp.full((TILE,), -1, jnp.int32),
            jnp.zeros((TILE,), jnp.float32),
            jnp.zeros((TILE,), jnp.float32),
        )
        _, bt, btri, bu, bv = jax.lax.while_loop(cond, body, init)
        return bt, btri, bu, bv

    bt, btri, bu, bv = jax.vmap(tile_trace)(o_t, d_t, t_max_t, lists, counts)
    bt, btri = bt.reshape(R)[:R_out], btri.reshape(R)[:R_out]
    # the winner's t evaluated accurately (grazing hits), as the CUDA
    # tracer does, so the two tracers agree to float rounding
    k = jnp.maximum(btri, 0)
    t_hit = exact_hit_t(ray_o[:R_out], ray_d[:R_out], v0[k], e1[k], e2[k])
    return {
        "t": jnp.where(btri >= 0, t_hit, bt),
        "tri": btri,
        "u": bu.reshape(R)[:R_out],
        "v": bv.reshape(R)[:R_out],
    }


@partial(jax.jit, static_argnames=("max_clusters",))
def trace_any(
    tris: dict,
    wc_min: jnp.ndarray,
    wc_max: jnp.ndarray,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    t_min,
    t_max,
    max_clusters: int | None = None,
):
    """Any-hit (shadow) rays: returns occluded mask (R,) bool.

    Same phases as trace_closest but terminates a tile as soon as all its
    rays are occluded (TerminateOnFirstHit analog, main.rgen shadow rays).
    """
    n_clusters = wc_min.shape[0]
    max_clusters = max_clusters or n_clusters
    t_max_full = jnp.broadcast_to(
        jnp.asarray(t_max, jnp.float32), (ray_o.shape[0],)
    )
    ray_o, ray_d, R_out = _pad_rays(ray_o, ray_d)
    R = ray_o.shape[0]
    n_tiles = R // TILE
    o_t = ray_o.reshape(n_tiles, TILE, 3)
    d_t = ray_d.reshape(n_tiles, TILE, 3)
    t_max_t = jnp.concatenate(
        [t_max_full, jnp.zeros((R - R_out,), jnp.float32)]
    ).reshape(n_tiles, TILE)
    t_min = jnp.asarray(t_min, jnp.float32)

    o_lo, o_hi = o_t.min(axis=1), o_t.max(axis=1)
    d_lo, d_hi = d_t.min(axis=1), d_t.max(axis=1)
    overlap = packet_aabb_overlap(
        o_lo[:, None, :],
        o_hi[:, None, :],
        d_lo[:, None, :],
        d_hi[:, None, :],
        wc_min[None, :, :],
        wc_max[None, :, :],
        t_max_t.max(axis=1)[:, None],
    )
    counts = jnp.minimum(overlap.sum(axis=1).astype(jnp.int32), max_clusters)
    order = jnp.argsort(~overlap, axis=1, stable=True)
    lists = order[:, :max_clusters].astype(jnp.int32)

    v0, e1, e2 = tris["v0"], tris["e1"], tris["e2"]

    def tile_trace(o, d, tmax0, clist, count):
        def cond(state):
            k, occ = state
            return (k < count) & ~jnp.all(occ)

        def body(state):
            k, occ = state
            c = clist[k]
            base = c * CLUSTER_PAD
            tv0 = jax.lax.dynamic_slice(v0, (base, 0), (CLUSTER_PAD, 3))
            te1 = jax.lax.dynamic_slice(e1, (base, 0), (CLUSTER_PAD, 3))
            te2 = jax.lax.dynamic_slice(e2, (base, 0), (CLUSTER_PAD, 3))
            hit, _, _, _ = moller_trumbore(
                o[:, None, :],
                d[:, None, :],
                tv0[None, :, :],
                te1[None, :, :],
                te2[None, :, :],
                t_min,
                tmax0[:, None],
            )
            return (k + 1, occ | jnp.any(hit, axis=1))

        _, occ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros((TILE,), bool))
        )
        return occ

    occ = jax.vmap(tile_trace)(o_t, d_t, t_max_t, lists, counts)
    return occ.reshape(R)[:R_out]
