"""Texture sampling: gather + decode + filter over the quad-packed arena.

The analog of Vulkan's sampler2D reads in materials.glsl
(/root/reference/res/shader/scene/materials.glsl:46-121): sRGB decode
happens per texel BEFORE filtering (matching VK_FORMAT_*_SRGB views);
glTF sampler wrap modes (REPEAT / CLAMP_TO_EDGE / MIRRORED_REPEAT) ride
per texture in the table flags (bits 1-4, scene/textures.py).

Arena layout (scene/textures.py): each mip is stored as (H*W, 4) u32
bilinear quads — texel (x,y) plus its +x/+y/+xy REPEAT neighbors — so a
bilinear tap is ONE 16-byte row gather instead of four scattered texel
gathers.

Sampling returns linear-space float RGBA.
"""

from __future__ import annotations

import jax.numpy as jnp


def _decode4(quads, srgb_mask, assume_linear=False):
    """(..., 4) u32 quads -> (..., 4, 4) linear float RGBA per corner.

    assume_linear statically skips the sRGB pow (12 transcendentals per
    quad): glTF metallicRoughness and normal maps are ALWAYS linear, so
    2/3 of material taps never need the decode."""
    p = quads.astype(jnp.uint32)
    r = (p & 0xFF).astype(jnp.float32) / 255.0
    g = ((p >> 8) & 0xFF).astype(jnp.float32) / 255.0
    b = ((p >> 16) & 0xFF).astype(jnp.float32) / 255.0
    a = ((p >> 24) & 0xFF).astype(jnp.float32) / 255.0
    rgb = jnp.stack([r, g, b], axis=-1)  # (..., 4, 3)
    if not assume_linear:
        lin = jnp.where(
            rgb <= 0.04045, rgb / 12.92, jnp.power((rgb + 0.055) / 1.055, 2.4)
        )
        rgb = jnp.where(srgb_mask[..., None, None], lin, rgb)
    return jnp.concatenate([rgb, a[..., None]], axis=-1)


def _wrap_coord(s, n, mode):
    """Continuous texel coordinate under a glTF wrap mode.

    s: normalized coord, n: (int) dimension, mode: 0 REPEAT /
    1 CLAMP_TO_EDGE / 2 MIRRORED_REPEAT (flags bits, scene/textures.py).
    Returns (texel_index, frac). CLAMP and MIRROR clip the continuous
    coordinate to [0, n-1], so the quad arena's baked REPEAT neighbors
    get zero bilinear weight at the edges — no separate edge quads."""
    nf = n.astype(jnp.float32)
    c = s * nf - 0.5
    clamped = jnp.clip(c, 0.0, nf - 1.0)
    m = jnp.mod(c + 0.5, 2.0 * nf)
    mirrored = jnp.clip(nf - jnp.abs(m - nf) - 0.5, 0.0, nf - 1.0)
    cw = jnp.where(mode == 1, clamped, jnp.where(mode == 2, mirrored, c))
    c0 = jnp.floor(cw)
    idx = c0.astype(jnp.int32)
    idx = jnp.where(mode == 0, jnp.mod(idx, n), idx)
    return idx, (cw - c0)


def _bilinear_entry(arena, entry, uv, assume_linear=False):
    """Bilinear sample given a (R, 4) table entry (off, w, h, flags)."""
    off = entry[..., 0]
    w = entry[..., 1]
    h = entry[..., 2]
    flags = entry[..., 3]
    srgb = (flags & 1) > 0

    x0, fu = _wrap_coord(uv[..., 0], w, (flags >> 1) & 3)
    y0, fv = _wrap_coord(uv[..., 1], h, (flags >> 3) & 3)
    fu = fu[..., None]
    fv = fv[..., None]

    quads = arena["data"][off + y0 * w + x0]  # (R, 4) one row gather
    t = _decode4(quads, srgb, assume_linear)  # (R, 4, 4): 00,10,01,11
    return (
        t[..., 0, :] * (1 - fu) * (1 - fv)
        + t[..., 1, :] * fu * (1 - fv)
        + t[..., 2, :] * (1 - fu) * fv
        + t[..., 3, :] * fu * fv
    )


def sample_bilinear(arena: dict, tex: jnp.ndarray, uv: jnp.ndarray, mip,
                    assume_linear=False):
    """Bilinear sample at integer mip. tex: (R,) i32 ids, uv: (R, 2)."""
    entry = arena["table"][tex, mip]
    return _bilinear_entry(arena, entry, uv, assume_linear)


def sample_trilinear(arena: dict, tex: jnp.ndarray, uv: jnp.ndarray, lod,
                     assume_linear=False):
    """Trilinear sample at fractional lod (clamped per texture)."""
    n_mips = arena["n_mips"][tex].astype(jnp.float32)
    lod = jnp.clip(lod, 0.0, n_mips - 1.0)
    m0 = jnp.floor(lod).astype(jnp.int32)
    m1 = jnp.minimum(m0 + 1, (n_mips - 1.0).astype(jnp.int32))
    f = (lod - m0.astype(jnp.float32))[..., None]
    s0 = sample_bilinear(arena, tex, uv, m0, assume_linear)
    s1 = sample_bilinear(arena, tex, uv, m1, assume_linear)
    return s0 * (1 - f) + s1 * f


def sample_aniso(arena: dict, tex: jnp.ndarray, uv: jnp.ndarray,
                 duv_major: jnp.ndarray, lod_minor, taps: int,
                 assume_linear=False):
    """Software anisotropic filter (the reference samples materials with
    maxAnisotropy=16, WorldData.cpp:693-714): `taps` trilinear samples
    spread along the UV-space major footprint axis at the MINOR-axis
    mip, averaged. duv_major: (R, 2) full major-axis extent in uv units;
    lod_minor: (R,) log2 texel extent of the minor axis."""
    assert taps >= 1
    if taps == 1:
        return sample_trilinear(arena, tex, uv, lod_minor, assume_linear)
    acc = None
    for i in range(taps):
        f = (i + 0.5) / taps - 0.5
        s = sample_trilinear(
            arena, tex, uv + f * duv_major, lod_minor, assume_linear
        )
        acc = s if acc is None else acc + s
    return acc / taps


def pack_material_tables(materials: dict, arena: dict):
    """Fold the material SoA + the three textures' mip-0 table entries
    into two row tables so sampleMaterial costs 2 row gathers + 3 quad
    gathers (XLA gathers rows fast, scattered scalars slowly).

    mat_f32 (M, 8):  base_color_factor[4], metallic, roughness, cutoff, 0
    mat_i32 (M, 16): alpha_mode, bc_tex, mr_tex, nrm_tex,
                     bc[off,w,h,flags], mr[off,w,h,flags], nrm[off,w,h,flags]
    """
    import numpy as np

    bc = np.asarray(materials["base_color_factor"])
    m = len(bc)
    f32 = np.zeros((m, 8), np.float32)
    f32[:, 0:4] = bc
    f32[:, 4] = np.asarray(materials["metallic_factor"])
    f32[:, 5] = np.asarray(materials["roughness_factor"])
    f32[:, 6] = np.asarray(materials["alpha_cutoff"])

    table = np.asarray(arena["table"])
    i32 = np.zeros((m, 16), np.int32)
    i32[:, 0] = np.asarray(materials["alpha_mode"])
    for j, key in enumerate(
        ["base_color_tex", "metallic_roughness_tex", "normal_tex"]
    ):
        tex = np.asarray(materials[key])
        i32[:, 1 + j] = tex
        i32[:, 4 + 4 * j : 8 + 4 * j] = table[tex, 0]
    return jnp.asarray(f32), jnp.asarray(i32)


def sample_material_packed(arena: dict, mat_idx: jnp.ndarray, uv, lod=None,
                           duv_major=None, aniso_taps: int = 1):
    """Fast-path sampleMaterial over the packed tables.

    lod=None: base-mip (the RT shaders' derivative-free texture()).
    lod given: per-ray log2 world-footprint-times-uv-density; each
    texture adds log2 of its own base dimension (ray-cone mip selection,
    the raster path's derivative LOD analog, Renderer.cpp:709-715).
    duv_major + aniso_taps > 1: anisotropic filtering — lod is then the
    MINOR-axis footprint and every texture takes `aniso_taps` trilinear
    taps along the uv-space major axis (maxAnisotropy=16 sampler parity,
    WorldData.cpp:693-714)."""
    f32 = arena["mat_f32"][mat_idx]  # (R, 8)
    i32 = arena["mat_i32"][mat_idx]  # (R, 16)

    if lod is None:
        def tex_sample(tex_ids, entry0, linear=False):
            del tex_ids
            return _bilinear_entry(arena, entry0, uv, assume_linear=linear)
    else:
        def tex_sample(tex_ids, entry0, linear=False):
            size = jnp.maximum(entry0[..., 1], entry0[..., 2]).astype(
                jnp.float32
            )
            lod_t = lod + jnp.log2(jnp.maximum(size, 1.0))
            if aniso_taps > 1 and duv_major is not None:
                return sample_aniso(
                    arena, tex_ids, uv, duv_major, lod_t, aniso_taps,
                    assume_linear=linear,
                )
            return sample_trilinear(
                arena, tex_ids, uv, lod_t, assume_linear=linear
            )

    base = tex_sample(i32[..., 1], i32[..., 4:8]) * f32[..., 0:4]
    alpha_mode = i32[..., 0]
    cutoff = f32[..., 6]
    alpha = jnp.where(
        alpha_mode == 2,
        base[..., 3],
        jnp.where((alpha_mode == 1) & (base[..., 3] < cutoff), 0.0, -1.0),
    )
    # glTF: metallicRoughness and normal maps are always linear
    mr = tex_sample(i32[..., 2], i32[..., 8:12], linear=True)
    roughness = jnp.maximum(mr[..., 1] * f32[..., 5], 0.05)
    metallic = mr[..., 2] * f32[..., 4]
    nrm = tex_sample(i32[..., 3], i32[..., 12:16], linear=True)
    normal_ts = jnp.where(
        (i32[..., 3] > 0)[..., None],
        nrm[..., :3] * 2.0 - 1.0,
        jnp.full(mat_idx.shape + (3,), -2.0, jnp.float32),
    )
    return {
        "albedo": base[..., :3],
        "alpha": alpha,
        "roughness": roughness,
        "metallic": metallic,
        "normal_ts": normal_ts,
    }


def sample_alpha_packed(arena: dict, mat_idx: jnp.ndarray, uv):
    """sampleAlpha over packed tables (materials.glsl:123-147): one quad
    gather. Returns the reference's signalling (-1 opaque, 0 failed mask,
    else blend alpha)."""
    f32 = arena["mat_f32"][mat_idx]
    i32 = arena["mat_i32"][mat_idx]
    a = _bilinear_entry(arena, i32[..., 4:8], uv)[..., 3] * f32[..., 3]
    alpha_mode = i32[..., 0]
    cutoff = f32[..., 6]
    return jnp.where(
        alpha_mode == 2,
        a,
        jnp.where((alpha_mode == 1) & (a < cutoff), 0.0, -1.0),
    )


def sample_material(arena: dict, materials: dict, mat_idx: jnp.ndarray, uv,
                    lod=None, footprint=False):
    """sampleMaterial parity (materials.glsl:46-121).

    lod=None means base-mip sampling (the RT shaders' texture() without
    derivatives), which takes the 1-gather-per-texture fast path.

    Returns dict: albedo (R,3) linear, alpha (R,) with the reference's
    signalling (-1 opaque, 0 failed mask test, else blend alpha),
    roughness, metallic (R,), normal_ts (R,3) with x == -2 when no normal
    map.
    """
    R = mat_idx.shape
    base_tex = materials["base_color_tex"][mat_idx]
    mr_tex = materials["metallic_roughness_tex"][mat_idx]
    nrm_tex = materials["normal_tex"][mat_idx]

    if lod is None:
        def tex_sample(tex_ids, linear=False):
            return _bilinear_entry(
                arena, arena["table"][tex_ids, 0], uv, assume_linear=linear
            )
    elif footprint:
        # lod is a per-ray log2 world-footprint * uv-density; add each
        # texture's own base dimension (see sample_material_packed)
        def tex_sample(tex_ids, linear=False):
            e0 = arena["table"][tex_ids, 0]
            size = jnp.maximum(e0[..., 1], e0[..., 2]).astype(jnp.float32)
            return sample_trilinear(
                arena, tex_ids, uv, lod + jnp.log2(jnp.maximum(size, 1.0)),
                assume_linear=linear,
            )
    else:
        def tex_sample(tex_ids, linear=False):
            return sample_trilinear(
                arena, tex_ids, uv, lod, assume_linear=linear
            )

    base = tex_sample(base_tex) * materials["base_color_factor"][mat_idx]

    alpha_mode = materials["alpha_mode"][mat_idx]
    cutoff = materials["alpha_cutoff"][mat_idx]
    # -1 opaque; mask: 0 if fail else -1; blend: alpha
    alpha = jnp.where(
        alpha_mode == 2,
        base[..., 3],
        jnp.where((alpha_mode == 1) & (base[..., 3] < cutoff), 0.0, -1.0),
    )

    # glTF: metallicRoughness and normal maps are always linear
    mr = tex_sample(mr_tex, linear=True)
    roughness = mr[..., 1] * materials["roughness_factor"][mat_idx]
    metallic = mr[..., 2] * materials["metallic_factor"][mat_idx]
    roughness = jnp.maximum(roughness, 0.05)

    nrm = tex_sample(nrm_tex, linear=True)
    normal_ts = jnp.where(
        (nrm_tex > 0)[..., None],
        nrm[..., :3] * 2.0 - 1.0,
        jnp.full(R + (3,), -2.0, jnp.float32),
    )

    return {
        "albedo": base[..., :3],
        "alpha": alpha,
        "roughness": roughness,
        "metallic": metallic,
        "normal_ts": normal_ts,
    }


def sample_alpha(arena: dict, materials: dict, mat_idx: jnp.ndarray, uv, lod=None):
    """sampleAlpha parity (materials.glsl:123-147): base-color alpha only,
    used by the stochastic any-hit path."""
    base_tex = materials["base_color_tex"][mat_idx]
    if lod is None:
        a = _bilinear_entry(arena, arena["table"][base_tex, 0], uv)[..., 3]
    else:
        a = sample_trilinear(arena, base_tex, uv, lod)[..., 3]
    a = a * materials["base_color_factor"][mat_idx][..., 3]
    alpha_mode = materials["alpha_mode"][mat_idx]
    cutoff = materials["alpha_cutoff"][mat_idx]
    return jnp.where(
        alpha_mode == 2,
        a,
        jnp.where((alpha_mode == 1) & (a < cutoff), 0.0, -1.0),
    )