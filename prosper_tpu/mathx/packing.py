"""Quantised vertex/G-buffer packing with parity to the reference formats.

Reference formats:
- positions f16x4      (/root/reference/src/scene/Mesh.hpp:11-12)
- normals/tangents 10-10-10-2 snorm (A2B10G10R10SnormPack32, Mesh.hpp:13-14)
- uv f16x2             (Mesh.hpp:15)
- G-buffer normal: signed-octahedron encoding
  (/root/reference/res/shader/gbuffer.frag:40-55; decode in
  res/shader/scene/visible_surface.glsl signedOctDecode)

These packings matter for the device-memory bandwidth of the flat
geometry arena: vertices stay quantised at rest and decode on use.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


# --- f16 position/uv quantisation -------------------------------------------------

def pack_f16(x: np.ndarray) -> np.ndarray:
    """Quantise float32 -> float16 at rest (host-side, numpy)."""
    return x.astype(np.float16)


def unpack_f16(x):
    return jnp.asarray(x).astype(jnp.float32)


# --- 10-10-10-2 snorm (A2B10G10R10) -----------------------------------------------

def _snorm_quant(x: np.ndarray, bits: int) -> np.ndarray:
    scale = float((1 << (bits - 1)) - 1)  # 511 for 10-bit, 1 for 2-bit
    q = np.rint(np.clip(x, -1.0, 1.0) * scale).astype(np.int32)
    return q & ((1 << bits) - 1)


def pack_snorm_10_10_10_2(v: np.ndarray, w: np.ndarray | None = None) -> np.ndarray:
    """Pack (..., 3) [+ optional w in {-1,1}] into uint32 A2B10G10R10 snorm.

    Bit layout matches Vulkan A2B10G10R10SnormPack32: R in bits 0-9, G 10-19,
    B 20-29, A 30-31.
    """
    r = _snorm_quant(v[..., 0], 10)
    g = _snorm_quant(v[..., 1], 10)
    b = _snorm_quant(v[..., 2], 10)
    if w is None:
        a = np.zeros(v.shape[:-1], dtype=np.int32)
    else:
        a = _snorm_quant(w, 2)
    return (r | (g << 10) | (b << 20) | (a << 30)).astype(np.uint32)


def _snorm_dequant(q, bits):
    scale = jnp.float32((1 << (bits - 1)) - 1)
    mask = (1 << bits) - 1
    q = (q & jnp.uint32(mask)).astype(jnp.int32)
    # sign extend
    sign_bit = 1 << (bits - 1)
    q = jnp.where(q >= sign_bit, q - (1 << bits), q)
    return jnp.maximum(q.astype(jnp.float32) / scale, -1.0)


def unpack_snorm_10_10_10_2(p):
    """uint32 -> ((...,3) vector, w scalar). Device-side (jnp)."""
    p = jnp.asarray(p, jnp.uint32)
    r = _snorm_dequant(p, 10)
    g = _snorm_dequant(p >> jnp.uint32(10), 10)
    b = _snorm_dequant(p >> jnp.uint32(20), 10)
    a = _snorm_dequant(p >> jnp.uint32(30), 2)
    return jnp.stack([r, g, b], axis=-1), a


# --- Signed-octahedron normal encoding (G-buffer) ----------------------------------

def signed_oct_encode(n):
    """(...,3) unit normal -> (...,3) encoded (gbuffer.frag:40-55)."""
    denom = jnp.abs(n[..., 0]) + jnp.abs(n[..., 1]) + jnp.abs(n[..., 2])
    n = n / jnp.maximum(denom, 1e-20)[..., None]
    out_y = n[..., 1] * 0.5 + 0.5
    out_x = n[..., 0] * 0.5 + out_y
    out_y = n[..., 0] * -0.5 + out_y
    out_z = jnp.clip(n[..., 2] * np.float32(3.40282e38), 0.0, 1.0)
    return jnp.stack([out_x, out_y, out_z], axis=-1)


def signed_oct_decode(e):
    """Inverse of signed_oct_encode (visible_surface.glsl signedOctDecode)."""
    x, y, z = e[..., 0], e[..., 1], e[..., 2]
    nx = x - y
    ny = x + y - 1.0
    nz = (z * 2.0 - 1.0) * (1.0 - jnp.abs(nx) - jnp.abs(ny))
    n = jnp.stack([nx, ny, nz], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


# --- Velocity / misc ---------------------------------------------------------------

def pack_velocity(v):
    """Clamp NDC-space velocity to [-1,1] like the R16G16 snorm target
    (gbuffer.frag:84; RenderTargets.hpp:13)."""
    return jnp.clip(v, -1.0, 1.0)
