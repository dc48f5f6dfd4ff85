"""Bokeh depth of field — Abadie "A Life of a Bokeh" scatter-as-gather.

Parity with /root/reference/res/shader/dof/* and src/render/dof/*:
- Setup: half-res bilateral color downsample + CoC = (1 - F/z) *
  maxBgCoC clamped to -maxCoC (setup.comp:25-30); maxBgCoC from the
  physical lens (Setup.cpp:163-176), fg factor 2 (DepthOfField.hpp:30)
- Flatten: 8x8 tile min/max CoC
- Dilate: tile window max/min with distance tests (dilate.comp:30-50)
- Gather: octaweb 6-ring kernel, interleaved rings; background buckets
  blended back-to-front with occlusion factor; foreground weight
  kernelRadius/sampleCoC with Jimenez alpha normalisation (gather.comp)
- Filter: 3x3 luminance median
- Combine: background lerp by saturate(coc-1), foreground by bucket
  weight; fg upscale via the bilateral filter (combine.comp)

Static octaweb offsets are unrolled (121 samples); per-pixel radii scale
them — everything stays dense elementwise math at half resolution.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..mathx.color import luminance

MAX_FG_COC_FACTOR = 2.0
RING_COUNT = 6
_SINGLE_PIXEL_RADIUS = 0.7071


def max_bg_coc_half_res(cam: dict, width: int) -> jnp.ndarray:
    """maxBackgroundCoC in half-res pixels (Setup.cpp:163-171)."""
    from ..scene.camera import SENSOR_WIDTH

    f = cam["focal_length"]
    units = (cam["aperture_diameter"] * f) / (cam["focus_distance"] - f)
    return (units / SENSOR_WIDTH) * (width // 2)


def _bilateral4(cw00, cw01, cw10, cw11):
    """bilateral.glsl bilateralFilter on 4 (..., 4) color+coc samples."""
    coc_out = jnp.minimum(
        jnp.minimum(cw01[..., 3], cw11[..., 3]),
        jnp.minimum(cw10[..., 3], cw00[..., 3]),
    )

    def w(cw):
        return jnp.clip(1.0 - (coc_out - cw[..., 3]), 0.0, 1.0)

    w01, w11, w10, w00 = w(cw01), w(cw11), w(cw10), w(cw00)
    norm = w01 + w11 + w10 + w00
    out = (
        w01[..., None] * cw01
        + w11[..., None] * cw11
        + w10[..., None] * cw10
        + w00[..., None] * cw00
    ) / jnp.maximum(norm[..., None], 1e-20)
    return out


def setup(illumination: jnp.ndarray, view_depth: jnp.ndarray, cam: dict):
    """Half-res illumination + CoC. view_depth: (H, W) positive distances
    along -z. Returns (half_illum (h,w,3), half_coc (h,w))."""
    H, W = view_depth.shape
    h, w = H // 2, W // 2
    max_bg = max_bg_coc_half_res(cam, W)
    max_coc = max_bg * MAX_FG_COC_FACTOR

    def coc(vd):
        return jnp.maximum(
            (1.0 - cam["focus_distance"] / vd) * max_bg, -max_coc
        )

    il = illumination[: h * 2, : w * 2].reshape(h, 2, w, 2, 3)
    vd = view_depth[: h * 2, : w * 2].reshape(h, 2, w, 2)
    cw = jnp.concatenate([il, coc(vd)[..., None]], axis=-1)
    out = _bilateral4(
        cw[:, 0, :, 1], cw[:, 1, :, 1], cw[:, 1, :, 0], cw[:, 0, :, 0]
    )
    return out[..., :3], out[..., 3]


def flatten(half_coc: jnp.ndarray):
    """8x8 tile min/max CoC (flatten.comp)."""
    h, w = half_coc.shape
    th, tw = -(-h // 8), -(-w // 8)
    padded = jnp.pad(
        half_coc, ((0, th * 8 - h), (0, tw * 8 - w)), mode="edge"
    )
    tiles = padded.reshape(th, 8, tw, 8)
    return tiles.min(axis=(1, 3)), tiles.max(axis=(1, 3))


def dilate(tile_min: jnp.ndarray, tile_max: jnp.ndarray, gather_radius: int):
    """dilate.comp:30-50."""
    th, tw = tile_min.shape
    r = gather_radius
    dmin = jnp.full_like(tile_min, jnp.inf)
    dmax = jnp.full_like(tile_max, -jnp.inf)
    pmin = jnp.pad(tile_min, r, mode="edge")
    pmax = jnp.pad(tile_max, r, mode="edge")
    for i in range(-r, r + 1):
        for j in range(-r, r + 1):
            nmin = pmin[r + i : r + i + th, r + j : r + j + tw]
            nmax = pmax[r + i : r + i + th, r + j : r + j + tw]
            dist = float(np.hypot(i, j)) * 8.0
            dmin = jnp.where(dist <= jnp.abs(nmin) + 4.0, jnp.minimum(dmin, nmin), dmin)
            dmax = jnp.where(dist <= jnp.abs(nmax) + 4.0, jnp.maximum(dmax, nmax), dmax)
    return dmin, dmax


def _octaweb_offsets():
    """Static unit-kernel offsets per ring (radius scaled per pixel)."""
    rings = []
    for ring in range(RING_COUNT):
        n = 1 if ring == 0 else 8 * ring
        rim = 2.0 * np.pi / n
        phis = np.arange(n) * rim + (rim * 0.5 if ring % 2 == 0 else 0.0)
        rings.append(
            (ring, np.stack([np.cos(phis), np.sin(phis)], -1).astype(np.float32))
        )
    return rings


_RINGS = _octaweb_offsets()


def _mip_chain(img: jnp.ndarray, n: int = 4) -> list[jnp.ndarray]:
    mips = [img]
    for _ in range(n - 1):
        m = mips[-1]
        h, w = m.shape[:2]
        mips.append(
            m[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2, -1).mean((1, 3))
        )
    return mips


def _sample_trilinear(mips: list[jnp.ndarray], uv: jnp.ndarray, mip: jnp.ndarray):
    """Trilinear-with-mip sample of the half-res illumination chain."""
    n = len(mips)
    mip = jnp.clip(mip, 0.0, n - 1.0)
    m0 = jnp.floor(mip)
    f = (mip - m0)[..., None]

    def bil(img, uv):
        h, w = img.shape[:2]
        x = uv[..., 0] * w - 0.5
        y = uv[..., 1] * h - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]

        def g(yi, xi):
            yi = jnp.clip(yi.astype(jnp.int32), 0, h - 1)
            xi = jnp.clip(xi.astype(jnp.int32), 0, w - 1)
            return img[yi, xi]

        return (
            g(y0, x0) * (1 - fx) * (1 - fy)
            + g(y0, x0 + 1) * fx * (1 - fy)
            + g(y0 + 1, x0) * (1 - fx) * fy
            + g(y0 + 1, x0 + 1) * fx * fy
        )

    out = jnp.zeros(uv.shape[:-1] + (mips[0].shape[-1],), mips[0].dtype)
    for lvl in range(n):
        sel0 = (m0 == lvl)[..., None]
        sel1 = (m0 == lvl - 1)[..., None]
        if lvl < n:
            s = bil(mips[lvl], uv)
            out = out + jnp.where(sel0, s * (1 - f), 0.0) + jnp.where(sel1, s * f, 0.0)
    return out


def _sample_alpha(coc):
    return jnp.minimum(
        1.0 / (np.pi * coc * coc),
        1.0 / (np.pi * _SINGLE_PIXEL_RADIUS**2),
    )


def _nearest(img, uv):
    h, w = img.shape[:2]
    x = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    return img[y, x]


def _tile_lookup(arr, h, w):
    ty = (jnp.arange(h) // 8).astype(jnp.int32)
    tx = (jnp.arange(w) // 8).astype(jnp.int32)
    return arr[ty[:, None], tx[None, :]]


def _pixel_coords(h, w):
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32) + 0.5,
        jnp.arange(w, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    return jnp.stack([xs, ys], -1)


def _ring_offset_table(ring: int) -> np.ndarray:
    for rr, offs in _RINGS:
        if rr == ring:
            return offs
    raise KeyError(ring)


def gather_background(half_illum, half_coc, dil_min, dil_max):
    """gather.comp gatherBackground, vectorised over all half-res px.

    Per-ring sample loops run as fori_loop over static offset tables to
    keep the compiled graph small (one sample subgraph per ring)."""
    h, w = half_coc.shape
    inv_res = jnp.array([1.0 / w, 1.0 / h], jnp.float32)
    coord = _pixel_coords(h, w)
    tmax = _tile_lookup(dil_max, h, w)

    mips = _mip_chain(half_illum)
    ring_spacing = tmax / (RING_COUNT - 1)

    prev_cw = jnp.zeros((h, w, 4))
    prev_coc = jnp.zeros((h, w))
    prev_n = jnp.zeros((h, w))

    for ring in range(RING_COUNT - 1, -1, -1):
        offs = jnp.asarray(_ring_offset_table(ring))  # (n_s, 2)
        n_s = offs.shape[0]
        ring_radius = ring * ring_spacing
        bordering = (ring + 0.5 + 1.0) * ring_spacing

        def sample_body(k, state, offs=offs, ring_radius=ring_radius, bordering=bordering):
            cur_cw, cur_coc, cur_n, prev_cw, prev_coc, prev_n = state
            o = offs[k]
            s = ring_radius[..., None] * o
            uv = (coord + s) * inv_res
            sc = _nearest(half_coc[..., None], uv)[..., 0]
            take = sc >= ring_radius
            to_cur = take & (sc < bordering)
            to_prev = take & ~(sc < bordering)
            mip = jnp.maximum(jnp.log2(jnp.maximum(sc, 1e-6)) - 1.0, 0.0)
            sw = _sample_alpha(sc)
            col = _sample_trilinear(mips, uv, mip)
            cw = jnp.concatenate([col * sw[..., None], sw[..., None]], -1)
            cur_cw = cur_cw + jnp.where(to_cur[..., None], cw, 0.0)
            cur_coc = cur_coc + jnp.where(to_cur, sc, 0.0)
            cur_n = cur_n + to_cur
            prev_cw = prev_cw + jnp.where(to_prev[..., None], cw, 0.0)
            prev_coc = prev_coc + jnp.where(to_prev, sc, 0.0)
            prev_n = prev_n + to_prev
            return (cur_cw, cur_coc, cur_n, prev_cw, prev_coc, prev_n)

        zero = jnp.zeros((h, w))
        state = (jnp.zeros((h, w, 4)), zero, zero, prev_cw, prev_coc, prev_n)
        cur_cw, cur_coc, cur_n, prev_cw, prev_coc, prev_n = jax.lax.fori_loop(
            0, n_s, sample_body, state
        )
        # blendBuckets
        cur_opacity = jnp.clip(cur_n / n_s, 0.0, 1.0)
        occluding = jnp.clip(
            prev_coc / jnp.maximum(prev_n, 1e-20)
            - cur_coc / jnp.maximum(cur_n, 1e-20),
            0.0,
            1.0,
        )
        blend = jnp.where(prev_cw[..., 3] == 0.0, 0.0, 1.0 - cur_opacity * occluding)
        prev_cw = prev_cw * blend[..., None] + cur_cw
        prev_coc = prev_coc * blend + cur_coc
        prev_n = prev_n * blend + cur_n

    color = prev_cw[..., :3] / jnp.maximum(prev_cw[..., 3:4], 1e-5)
    color = jnp.where((tmax < 1.0)[..., None], 0.0, color)
    return color


# flattened (unit offset, ring index) tables for the foreground loop
_FG_OFFSETS = np.concatenate([offs for _, offs in _RINGS]).astype(np.float32)
_FG_RINGS = np.concatenate(
    [np.full(len(offs), ring, np.float32) for ring, offs in _RINGS]
)


def gather_foreground(half_illum, half_coc, dil_min, dil_max):
    """gather.comp gatherForeground (single fori over all 121 samples)."""
    h, w = half_coc.shape
    inv_res = jnp.array([1.0 / w, 1.0 / h], jnp.float32)
    coord = _pixel_coords(h, w)
    tmin = _tile_lookup(dil_min, h, w)

    kernel_radius = -tmin
    ring_spacing = kernel_radius / (RING_COUNT - 1)
    mips = _mip_chain(half_illum)

    offs = jnp.asarray(_FG_OFFSETS)
    rings = jnp.asarray(_FG_RINGS)
    n_total = len(_FG_OFFSETS)

    def body(k, state):
        color_sum, alpha_sum, weight_sum = state
        ring_radius = rings[k] * ring_spacing
        s = ring_radius[..., None] * offs[k]
        uv = (coord + s) * inv_res
        sc = -_nearest(half_coc[..., None], uv)[..., 0]
        ok = (sc >= 0.5) & (sc >= jnp.sqrt(jnp.sum(s * s, -1)) - ring_spacing)
        mip = jnp.maximum(jnp.floor(jnp.log2(jnp.maximum(sc, 1e-6))) - 1.0, 0.0)
        sw = kernel_radius / jnp.maximum(sc, 1e-5)
        col = _sample_trilinear(mips, uv, mip)
        color_sum = color_sum + jnp.where(ok[..., None], col * sw[..., None], 0.0)
        alpha_sum = alpha_sum + jnp.where(
            ok, _sample_alpha(sc) * jnp.clip(sc - 0.5, 0.0, 1.0), 0.0
        )
        weight_sum = weight_sum + jnp.where(ok, sw, 0.0)
        return (color_sum, alpha_sum, weight_sum)

    color_sum, alpha_sum, weight_sum = jax.lax.fori_loop(
        0,
        n_total,
        body,
        (jnp.zeros((h, w, 3)), jnp.zeros((h, w)), jnp.zeros((h, w))),
    )

    color = color_sum / jnp.maximum(weight_sum[..., None], 1e-3)
    weight = jnp.clip(
        2.0
        * (1.0 / n_total)
        * (1.0 / _sample_alpha(jnp.maximum(kernel_radius, 1e-5)))
        * alpha_sum,
        0.0,
        1.0,
    )
    active = tmin <= -0.5
    return jnp.where(
        active[..., None],
        jnp.concatenate([color, weight[..., None]], -1),
        0.0,
    )


def median3x3(cw: jnp.ndarray) -> jnp.ndarray:
    """3x3 luminance median (filter.comp)."""
    h, w = cw.shape[:2]
    padded = jnp.pad(cw, ((1, 1), (1, 1), (0, 0)), mode="edge")
    stack = []
    for dy in range(3):
        for dx in range(3):
            stack.append(padded[dy : dy + h, dx : dx + w])
    n = jnp.stack(stack)  # (9, H, W, 4)
    lum = luminance(n[..., :3])  # (9, H, W)
    order = jnp.argsort(lum, axis=0)
    med = order[4]
    return jnp.take_along_axis(n, med[None, ..., None], axis=0)[0]


def combine(illumination, fg_cw, bg_cw, half_coc):
    """combine.comp."""
    H, W = illumination.shape[:2]
    ys = jnp.arange(H) // 2
    xs = jnp.arange(W) // 2
    coc = half_coc[ys[:, None], xs[None, :]]

    # background: average of 00/10/10/11 half-res taps (reference's mix chain)
    h2, w2 = bg_cw.shape[:2]

    def at(img, dy, dx):
        y = jnp.clip((jnp.arange(H)[:, None] + dy) // 2, 0, h2 - 1)
        x = jnp.clip((jnp.arange(W)[None, :] + dx) // 2, 0, w2 - 1)
        return img[y, x]

    bg00 = at(bg_cw, 0, 0)
    bg10 = at(bg_cw, 1, 0)
    bg11 = at(bg_cw, 1, 1)
    bg = (bg00 * 0.5 + bg10 * 0.5) * 0.5 + (bg10 * 0.5 + bg11 * 0.5) * 0.5

    out = illumination
    bg_factor = jnp.clip(coc - 1.0, 0.0, 1.0)
    out = jnp.where(
        (bg_factor > 0.0)[..., None],
        out * (1 - bg_factor[..., None]) + bg[..., :3] * bg_factor[..., None],
        out,
    )

    fg = _bilateral4(at(fg_cw, 1, 0), at(fg_cw, 1, 1), at(fg_cw, 0, 1), at(fg_cw, 0, 0))
    out = jnp.where(
        (fg[..., 3] > 0.0)[..., None],
        out * (1 - fg[..., 3:4]) + fg[..., :3] * fg[..., 3:4],
        out,
    )
    return out


@jax.jit
def depth_of_field(illumination: jnp.ndarray, view_depth: jnp.ndarray, cam: dict):
    """Full DoF chain (DepthOfField::record order)."""
    half_illum, half_coc = setup(illumination, view_depth, cam)
    tmin, tmax = flatten(half_coc)
    # gather radius from max CoC in tiles (Dilate.cpp:106-120) — use a
    # fixed conservative radius in tile units
    dmin, dmax = dilate(tmin, tmax, gather_radius=4)
    bg = gather_background(half_illum, half_coc, dmin, dmax)
    bg = jnp.concatenate([bg, jnp.zeros_like(bg[..., :1])], -1)
    fg = gather_foreground(half_illum, half_coc, dmin, dmax)
    bg = median3x3(bg)
    fg = median3x3(fg)
    return combine(illumination, fg, bg, half_coc)
