"""Color-space helpers with parity to the reference's common/math.glsl.

Reference: /root/reference/res/shader/common/math.glsl:15 (luminance),
:17-42 (rgbToHsv, hue in [0,6)), :44-78 (hsvToRgb). The branchy GLSL is
re-expressed branchless with jnp.where so it vectorises.
"""

from __future__ import annotations

import jax.numpy as jnp

LUMA_WEIGHTS = jnp.array([0.299, 0.587, 0.114], dtype=jnp.float32)


def luminance(c):
    """Y' = dot((.299,.587,.114), rgb) (math.glsl:15). c: (...,3)."""
    return jnp.einsum("...c,c->...", c, LUMA_WEIGHTS.astype(c.dtype))


def rgb_to_hsv(rgb):
    """HSV with hue in [0,6) (math.glsl:17-42)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    value = jnp.maximum(jnp.maximum(r, g), b)
    vmc = jnp.minimum(jnp.minimum(r, g), b)
    chroma = value - vmc
    safe = jnp.where(chroma == 0.0, 1.0, chroma)
    hue_r = jnp.mod((g - b) / safe, 6.0)
    hue_g = (b - r) / safe + 2.0
    hue_b = (r - g) / safe + 4.0
    hue = jnp.where(value == r, hue_r, jnp.where(value == g, hue_g, hue_b))
    hue = jnp.where(chroma == 0.0, 0.0, hue)
    sat = jnp.where(value == 0.0, 0.0, chroma / jnp.where(value == 0.0, 1.0, value))
    return jnp.stack([hue, sat, value], axis=-1)


def hsv_to_rgb(hsv):
    """Inverse of rgb_to_hsv (math.glsl:44-78)."""
    hue, sat, value = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    chroma = value * sat
    x = chroma * (1.0 - jnp.abs(jnp.mod(hue, 2.0) - 1.0))
    z = jnp.zeros_like(chroma)

    def pick(a, b, c):
        return jnp.stack([a, b, c], axis=-1)

    h = hue[..., None]
    rgb = jnp.where(
        h < 1.0, pick(chroma, x, z),
        jnp.where(
            h < 2.0, pick(x, chroma, z),
            jnp.where(
                h < 3.0, pick(z, chroma, x),
                jnp.where(
                    h < 4.0, pick(z, x, chroma),
                    jnp.where(h < 5.0, pick(x, z, chroma), pick(chroma, z, x)),
                ),
            ),
        ),
    )
    m = (value - chroma)[..., None]
    return rgb + m


def srgb_encode_gamma22(c):
    """The reference's display transform tail: pow(c, 1/2.2)
    (tone_map.comp:56-58). Not the piecewise sRGB EOTF."""
    return jnp.power(jnp.maximum(c, 0.0), 1.0 / 2.2)


def srgb_to_linear(c):
    """Piecewise sRGB EOTF used when decoding sRGB-classified textures
    (matches Vulkan's automatic sRGB view decode of baseColor/emissive)."""
    c = jnp.asarray(c)
    lo = c / 12.92
    hi = jnp.power((c + 0.055) / 1.055, 2.4)
    return jnp.where(c <= 0.04045, lo, hi)


def linear_to_srgb(c):
    lo = c * 12.92
    hi = 1.055 * jnp.power(jnp.maximum(c, 1e-12), 1.0 / 2.4) - 0.055
    return jnp.where(c <= 0.0031308, lo, hi)
