"""Display transform: exposure -> HSV contrast -> 48^3 display LUT ->
inverse gamma. Parity with the reference's tone_map.comp:17-60.

The reference samples Tony McMapface's 48^3 LUT
(res/texture/tony_mc_mapface.dds, R9G9B9E5) trilinearly with texel-center
alignment; so does `tone_map` here, with whatever LUT it is given. The
repository does not ship Tony's LUT: `generated_lut()` builds the default
in code, and `load_tony_mc_mapface(path)` reads the real one from an
explicit path (the CLI's --lut).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..io.dds import read_dds
from ..mathx.color import hsv_to_rgb, rgb_to_hsv

LUT_DIMS = 48


def generated_lut() -> np.ndarray:
    """The default display LUT, double-quad-packed (48^3, 24) float32.

    It is the identity in the LUT's encoded space (texel i holds i / 47),
    so the display curve is the plain `x / (1 + x)` per channel that
    tony_mc_mapface() encodes with. This departs from Tony McMapface,
    which also desaturates bright colors toward white and shapes the
    hue of highlights; pass the real LUT through load_tony_mc_mapface
    for that look."""
    ramp = np.arange(LUT_DIMS, dtype=np.float32) / (LUT_DIMS - 1)
    z, y, x = np.meshgrid(ramp, ramp, ramp, indexing="ij")
    return pack_lut_quads(np.stack([x, y, z], axis=-1))


def load_tony_mc_mapface(path: str) -> np.ndarray:
    """Tony McMapface's LUT from its DDS file, double-quad-packed
    (48^3, 24) float32 (see pack_lut_quads)."""
    img = read_dds(path)
    lut = img.mips[0]
    assert lut.shape == (LUT_DIMS, LUT_DIMS, LUT_DIMS, 3)
    return pack_lut_quads(lut.astype(np.float32))


def pack_lut_quads(lut: np.ndarray) -> np.ndarray:
    """(48,48,48,3) -> (48^3, 24): row (z,y,x) holds BOTH z-slices'
    clamped x/y bilinear quads [quad(z) | quad(z+1)], so a trilinear
    fetch is ONE row gather instead of eight corner gathers — XLA
    row-gather throughput bound the tone map at 1080p."""
    d = LUT_DIMS
    i = np.arange(d)
    i1 = np.minimum(i + 1, d - 1)
    q = np.stack(
        [
            lut,
            lut[:, :, i1],
            lut[:, i1, :],
            lut[:, i1, :][:, :, i1],
        ],
        axis=-2,
    )  # (z, y, x, 4, 3)
    rows = q.reshape(d, d * d, 12)
    rows_z1 = np.concatenate([rows[1:], rows[-1:]], axis=0)
    return np.concatenate([rows, rows_z1], axis=-1).reshape(
        d * d * d, 24
    ).astype(np.float32)


def sample_lut_trilinear(lut: jnp.ndarray, uvw: jnp.ndarray) -> jnp.ndarray:
    """Trilinear 3D LUT fetch; uvw in [0,1]^3 maps to texel centers already
    (caller applies the (d-1)/d + 0.5/d alignment).

    lut: double-quad-packed (48^3, 24) (one row gather) or raw
    (48,48,48,3) (8 corner gathers; kept for synthetic test LUTs)."""
    d = LUT_DIMS
    # uvw -> continuous texel coords (centers at i+0.5)
    c = uvw * d - 0.5
    c0 = jnp.floor(c)
    f = c - c0
    i0 = jnp.clip(c0.astype(jnp.int32), 0, d - 1)
    i1 = jnp.clip(i0 + 1, 0, d - 1)

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]

    if lut.ndim == 2:
        qq = lut[(z0 * d + y0) * d + x0]  # (..., 24): both z quads
        q0 = qq[..., 0:12]
        q1 = qq[..., 12:24]

        def bil(q):
            c00 = q[..., 0:3]
            c10 = q[..., 3:6]
            c01 = q[..., 6:9]
            c11 = q[..., 9:12]
            return (
                (c00 * (1 - fx) + c10 * fx) * (1 - fy)
                + (c01 * (1 - fx) + c11 * fx) * fy
            )

        return bil(q0) * (1 - fz) + bil(q1) * fz

    def g(z, y, x):
        return lut[z, y, x]

    c000 = g(z0, y0, x0)
    c100 = g(z0, y0, x1)
    c010 = g(z0, y1, x0)
    c110 = g(z0, y1, x1)
    c001 = g(z1, y0, x0)
    c101 = g(z1, y0, x1)
    c011 = g(z1, y1, x0)
    c111 = g(z1, y1, x1)

    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0_ = c00 * (1 - fy) + c10 * fy
    c1_ = c01 * (1 - fy) + c11 * fy
    return c0_ * (1 - fz) + c1_ * fz


def tony_mc_mapface(lut: jnp.ndarray, stimulus: jnp.ndarray) -> jnp.ndarray:
    """tone_map.comp:16-28."""
    encoded = stimulus / (stimulus + 1.0)
    uv = encoded * ((LUT_DIMS - 1.0) / LUT_DIMS) + 0.5 / LUT_DIMS
    return sample_lut_trilinear(lut, uv)


def tone_map(
    color: jnp.ndarray,
    lut: jnp.ndarray,
    exposure: float = 1.0,
    contrast: float = 1.0,
) -> jnp.ndarray:
    """Full display transform (tone_map.comp:31-60). color: (..., 3) linear
    HDR -> (..., 3) gamma-encoded display."""
    color = color * exposure
    hsv = rgb_to_hsv(color)
    hsv = hsv.at[..., 2].set(jnp.power(jnp.maximum(hsv[..., 2], 0.0), contrast))
    color = hsv_to_rgb(hsv)
    color = tony_mc_mapface(lut, color)
    return jnp.power(jnp.maximum(color, 0.0), 1.0 / 2.2)
