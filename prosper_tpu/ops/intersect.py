"""Ray-primitive intersection math (pure jnp) for the plain XLA tracer;
cuda/trace_bvh.cu repeats the Moller-Trumbore test line for line.

This replaces the Vulkan RT pipeline's fixed-function triangle/AABB tests
(/root/reference/src/render/RtReference.cpp RT pipeline + BLAS/TLAS,
SURVEY.md §7 "wavefront path tracer"). No backface culling, matching the
reference's RT pipeline defaults.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_DET_EPS = 1e-10


def moller_trumbore(o, d, v0, e1, e2, t_min, t_max):
    """Batched Möller-Trumbore.

    o, d: (..., 3) rays; v0, e1, e2: (..., 3) triangles (broadcastable
    against the rays). Returns (hit_mask, t, u, v).
    """
    p = jnp.cross(d, e2)
    det = jnp.sum(e1 * p, axis=-1)
    ok = jnp.abs(det) > _DET_EPS
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * p, axis=-1) * inv
    q = jnp.cross(tvec, e1)
    v = jnp.sum(d * q, axis=-1) * inv
    t = jnp.sum(e2 * q, axis=-1) * inv
    hit = (
        ok
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return hit, t, u, v


def _split(a):
    """a = hi + lo exactly, each with at most 12 significant bits, so
    products of halves are exact in float32 (Dekker's split by masking
    the low mantissa bits; no multiply that FMA contraction could
    change)."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32) & jnp.uint32(0xFFFFF000)
    hi = jax.lax.bitcast_convert_type(bits, jnp.float32)
    return hi, a - hi


def _two_prod(a, b):
    """a * b = p + e exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    """a + b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _dot2(xs, ys):
    """Sum of x * y over double-float pairs x = (hi, lo), y = (hi, lo),
    in twice the working precision (Ogita-Rump-Oishi Dot2), rounded once
    to float32."""
    s = jnp.zeros_like(xs[0][0])
    c = jnp.zeros_like(s)
    for (xh, xl), (yh, yl) in zip(xs, ys):
        p, e = _two_prod(xh, yh)
        s, f = _two_sum(s, p)
        c = c + (e + f + (xh * yl + xl * yh))
    return s + c


def exact_hit_t(o, d, v0, e1, e2):
    """Ray parameter of the intersection with the triangle's plane,
    t = (v0 - o) . n / (d . n) with n = e1 x e2, evaluated in
    double-float arithmetic and rounded to float32.

    Moller-Trumbore's float32 t loses about ulp / |cos| of relative
    accuracy at a grazing angle, so two correct implementations disagree
    there by 1e-4 or more. Evaluated this way t is within a few ulps of
    the exact value of the float inputs; the CUDA tracer computes the
    same quantity in float64, so the two agree to float rounding.
    """
    z = jnp.zeros_like(o[..., 0])

    def cross_comp(i, j):
        # n_k = e1_i e2_j - e1_j e2_i as a double-float (hi, lo)
        p1, r1 = _two_prod(e1[..., i], e2[..., j])
        p2, r2 = _two_prod(e1[..., j], e2[..., i])
        s, r = _two_sum(p1, -p2)
        return _two_sum(s, r + (r1 - r2))

    n = [cross_comp(1, 2), cross_comp(2, 0), cross_comp(0, 1)]
    w = [_two_sum(v0[..., k], -o[..., k]) for k in range(3)]
    dd = [(d[..., k], z) for k in range(3)]
    return _dot2(w, n) / _dot2(dd, n)


def packet_aabb_overlap(
    o_lo, o_hi, d_lo, d_hi, bmin, bmax, t_max
):
    """Conservative interval-arithmetic slab test of a ray packet
    (origin box [o_lo,o_hi], direction box [d_lo,d_hi]) against AABBs.

    Never reports 'no overlap' when any contained ray could hit: axes whose
    direction interval spans zero are treated as non-restricting. Shapes:
    packet bounds (..., 3); AABBs (..., 3) broadcastable. Returns bool.
    """
    # interval reciprocal where sign is uniform
    pos = d_lo > 0.0
    neg = d_hi < 0.0
    uniform = pos | neg
    inv_a = jnp.where(uniform, 1.0 / jnp.where(uniform, d_hi, 1.0), 0.0)
    inv_b = jnp.where(uniform, 1.0 / jnp.where(uniform, d_lo, 1.0), 0.0)

    # interval endpoints of (bound - origin)
    lo0 = bmin - o_hi
    hi0 = bmin - o_lo
    lo1 = bmax - o_hi
    hi1 = bmax - o_lo

    def imul_min(alo, ahi, ba, bb):
        return jnp.minimum(
            jnp.minimum(alo * ba, alo * bb), jnp.minimum(ahi * ba, ahi * bb)
        )

    def imul_max(alo, ahi, ba, bb):
        return jnp.maximum(
            jnp.maximum(alo * ba, alo * bb), jnp.maximum(ahi * ba, ahi * bb)
        )

    # entry uses the near bound per sign; take conservative min/max across
    # both bounds (cheap and safe)
    t_enter_ax = jnp.minimum(
        imul_min(lo0, hi0, inv_a, inv_b), imul_min(lo1, hi1, inv_a, inv_b)
    )
    t_exit_ax = jnp.maximum(
        imul_max(lo0, hi0, inv_a, inv_b), imul_max(lo1, hi1, inv_a, inv_b)
    )
    big = jnp.float32(3e38)
    t_enter_ax = jnp.where(uniform, t_enter_ax, -big)
    t_exit_ax = jnp.where(uniform, t_exit_ax, big)
    # a zero-spanning axis cannot restrict unless the origin box is fully
    # outside the slab and can never move in; conservatively keep it open
    enter = jnp.max(t_enter_ax, axis=-1)
    exit_ = jnp.min(t_exit_ax, axis=-1)
    # inverted (masked-out) AABBs never overlap
    valid = jnp.all(bmin <= bmax, axis=-1)
    return valid & (enter <= exit_) & (exit_ >= 0.0) & (enter <= t_max)
