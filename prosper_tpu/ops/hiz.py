"""Hierarchical depth (HiZ) pyramid.

Parity with /root/reference/res/shader/hiz_downsampler.comp (AMD FFX SPD
single-dispatch downsampler): reverse-z MIN reduction, power-of-2 rounded
dimensions, <=12 mips, out-of-bounds reads clamp to 1 (near, neutral for
min). Here the whole pyramid is one jit region of strided min-reductions
(XLA fuses the chain); the single-pass SPD structure exists to avoid
inter-dispatch barriers, which jit program order already provides
(SURVEY.md §7: barriers -> program order).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

MAX_HIZ_MIPS = 12


def hiz_dimensions(width: int, height: int) -> tuple[int, int]:
    """Power-of-2 rounded HiZ mip-0 size (half the render resolution,
    rounded up to pow2 like the reference's pyramid)."""
    w = 1 << int(np.ceil(np.log2(max(width // 2, 1))))
    h = 1 << int(np.ceil(np.log2(max(height // 2, 1))))
    return w, h


def build_hiz(depth: jnp.ndarray, width: int, height: int) -> list[jnp.ndarray]:
    """(H, W) reverse-z depth -> list of mips [mip0 .. mipN].

    Mip 0 is the pow2-rounded half-res min-reduction of the depth buffer
    ("hiz mip 0 is depth mip 1", draw_list_culler.comp:129-131).
    """
    hw, hh = hiz_dimensions(width, height)
    # pad depth to 2*pow2 with 1.0 (near; neutral for reverse-z min)
    pw, ph = hw * 2, hh * 2
    padded = jnp.full((ph, pw), 1.0, depth.dtype)
    padded = padded.at[:height, :width].set(depth)
    mip = padded.reshape(hh, 2, hw, 2).min(axis=(1, 3))
    mips = [mip]
    while min(mip.shape) > 1 and len(mips) < MAX_HIZ_MIPS:
        h, w = mip.shape
        mip = mip.reshape(h // 2, 2, w // 2, 2).min(axis=(1, 3))
        mips.append(mip)
    return mips
