"""Image-based lighting: cubemaps, split-sum LUT, irradiance + prefiltered
radiance generation, and the IBL shading term.

Parity with /root/reference/res/shader/ibl/*.comp and scene/skybox.glsl:
- specular BRDF LUT: Karis split-sum, 1024 Hammersley samples
  (integrate_specular_brdf.comp; 512^2 per WorldRenderStructs.hpp:50-52)
- irradiance cubemap 64^2: 128x64 spherical quadrature with the peak
  clamp at 10 (sample_irradiance.comp)
- GGX-prefiltered radiance mips, 1024 samples, NoL-weighted
  (prefilter_radiance.comp)
- evalIBL: kD/F split, irradiance*albedo + prefiltered*(F*A+B)
  (skybox.glsl:48-78), MAX_REFLECTION_LOD 10

Cubemap layout: (6, S, S, 3) float32 with the reference's face
orientation (sample_irradiance.comp:24-66). The environment source is
procedural (the reference's .ktx env maps are not in this mount); the
cache/IO architecture accepts real cubemaps when present.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..mathx.rng import hammersley
from .brdf import (
    fresnel_zero,
    importance_sample_ibl_trowbridge_reitz,
    schlick_fresnel_with_roughness,
    schlick_trowbridge_reitz,
    saturate,
)

SPECULAR_BRDF_LUT_RES = 512
IRRADIANCE_RES = 64
RADIANCE_RES = 512
MAX_REFLECTION_LOD = 10.0


def face_directions(res: int) -> jnp.ndarray:
    """(6, S, S, 3) unit directions through texel centers, face convention
    of sample_irradiance.comp:24-66."""
    c = np.arange(res, dtype=np.float32) + 0.5
    cy, cx = np.meshgrid(c, c, indexing="ij")
    half = res * 0.5
    faces = []
    # level 0..5 mappings from the GLSL
    faces.append(np.stack([np.full_like(cx, half), (res - cy) - half, (res - cx) - half], -1))
    faces.append(np.stack([np.full_like(cx, -half), (res - cy) - half, cx - half], -1))
    faces.append(np.stack([cx - half, np.full_like(cx, half), cy - half], -1))
    faces.append(np.stack([cx - half, np.full_like(cx, -half), (res - cy) - half], -1))
    faces.append(np.stack([cx - half, (res - cy) - half, np.full_like(cx, half)], -1))
    faces.append(np.stack([(res - cx) - half, (res - cy) - half, np.full_like(cx, -half)], -1))
    d = np.stack(faces)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(d.astype(np.float32))


def pack_cubemap_rows(cube: jnp.ndarray) -> jnp.ndarray:
    """Quad-pack a (6,S,S,3) cubemap into (6*S*S, 12) bilinear rows.

    Texel + its +x/+y/+xy clamp neighbors ride one 12-float row so a
    bilinear tap is ONE row gather instead of 4 multi-axis gathers.
    Precompute this ONCE per cubemap (outside any per-bounce loop) and
    pass the result to sample_cubemap — repacking inside a fori_loop
    body costs 4x the cubemap's memory traffic per trace step.
    """
    right = jnp.concatenate([cube[:, :, 1:], cube[:, :, -1:]], axis=2)
    down = jnp.concatenate([cube[:, 1:], cube[:, -1:]], axis=1)
    diag = jnp.concatenate([down[:, :, 1:], down[:, :, -1:]], axis=2)
    S = cube.shape[1]
    return jnp.concatenate([cube, right, down, diag], axis=-1).reshape(
        6 * S * S, 12
    )


def sample_cubemap(cube: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Nearest-face bilinear cubemap fetch. d (...,3).

    cube: either a raw (6,S,S,3) map (packed on the fly — fine for
    one-off calls) or pre-packed (6*S*S, 12) rows from
    pack_cubemap_rows."""
    if cube.ndim == 2:
        rows = cube
        S = int(round((cube.shape[0] // 6) ** 0.5))
        assert 6 * S * S == cube.shape[0], cube.shape
    else:
        rows = None
        S = cube.shape[1]
    ax = jnp.abs(d)
    major = jnp.argmax(ax, axis=-1)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    pos = jnp.take_along_axis(d, major[..., None], axis=-1)[..., 0] >= 0
    face = major * 2 + jnp.where(pos, 0, 1)

    m = jnp.take_along_axis(ax, major[..., None], axis=-1)[..., 0]
    m = jnp.maximum(m, 1e-20)
    xn, yn, zn = x / m, y / m, z / m

    # face-local (u, v), the inverse of face_directions' mappings
    u = jnp.where(
        face == 0, -zn,
        jnp.where(face == 1, zn,
        jnp.where(face == 5, -xn, xn)))
    v = jnp.where(face == 2, zn, jnp.where(face == 3, -zn, -yn))

    # clamp-to-edge in continuous coords: border taps then blend the
    # edge texel with itself (identical to clamping each corner index)
    uu = jnp.clip((u * 0.5 + 0.5) * S - 0.5, 0.0, S - 1.0)
    vv = jnp.clip((v * 0.5 + 0.5) * S - 0.5, 0.0, S - 1.0)
    x0 = jnp.floor(uu)
    y0 = jnp.floor(vv)
    fu = (uu - x0)[..., None]
    fv = (vv - y0)[..., None]

    if rows is None:
        rows = pack_cubemap_rows(cube)
    xc = jnp.clip(x0.astype(jnp.int32), 0, S - 1)
    yc = jnp.clip(y0.astype(jnp.int32), 0, S - 1)
    r = rows[(face * S + yc) * S + xc]
    return (
        r[..., 0:3] * (1 - fu) * (1 - fv)
        + r[..., 3:6] * fu * (1 - fv)
        + r[..., 6:9] * (1 - fu) * fv
        + r[..., 9:12] * fu * fv
    )


def procedural_sky(res: int = 256, sun_dir=(-1.0, -1.0, -1.0)) -> jnp.ndarray:
    """Simple gradient + sun environment for tests/demos (the reference's
    KTX env maps are absent from this mount)."""
    d = face_directions(res)
    sd = np.asarray(sun_dir, np.float32)
    sd = -sd / np.linalg.norm(sd)
    horizon = jnp.array([0.6, 0.7, 0.85])
    zenith = jnp.array([0.2, 0.35, 0.7])
    t = jnp.clip(d[..., 1:2], 0.0, 1.0)
    sky = horizon * (1 - t) + zenith * t
    ground = jnp.array([0.25, 0.22, 0.2]) * (0.4 + 0.6 * jnp.clip(-d[..., 1:2], 0, 1))
    base = jnp.where(d[..., 1:2] >= 0, sky, ground)
    sun = jnp.clip(jnp.einsum("fijc,c->fij", d, jnp.asarray(sd)), 0, 1) ** 512
    return (base + sun[..., None] * jnp.array([50.0, 45.0, 40.0])).astype(jnp.float32)


@partial(jax.jit, static_argnames=("res", "n_samples"))
def integrate_specular_brdf(res: int = SPECULAR_BRDF_LUT_RES, n_samples: int = 1024):
    """(res, res, 2) split-sum LUT; x = NoV, y = roughness."""
    nov = (jnp.arange(res, dtype=jnp.float32)) / res
    rough = (jnp.arange(res, dtype=jnp.float32)) / res
    NoV, R = jnp.meshgrid(nov, rough, indexing="xy")  # (res, res): x NoV, y rough
    alpha = R * R
    V = jnp.stack([jnp.sqrt(jnp.maximum(1 - NoV * NoV, 0.0)), jnp.zeros_like(NoV), NoV], -1)
    N = jnp.array([0.0, 0.0, 1.0])

    def body(i, ab):
        xi = hammersley(jnp.full((), i, jnp.uint32), n_samples)
        H = importance_sample_ibl_trowbridge_reitz(
            xi, alpha, jnp.broadcast_to(N, V.shape)
        )
        L = 2.0 * jnp.sum(V * H, -1, keepdims=True) * H - V
        NoL = saturate(L[..., 2])
        NoH = saturate(H[..., 2])
        VoH = saturate(jnp.sum(V * H, -1))
        G = schlick_trowbridge_reitz(NoL, NoV, alpha)
        g_vis = jnp.where(
            NoL > 0, G * VoH / jnp.maximum(NoH * NoV, 1e-8), 0.0
        )
        fc = jnp.power(1 - VoH, 5.0)
        return ab + jnp.stack([(1 - fc) * g_vis, fc * g_vis], -1)

    ab = jax.lax.fori_loop(0, n_samples, body, jnp.zeros((res, res, 2)))
    return jnp.clip(ab / n_samples, 0.0, 1.0)


@partial(jax.jit, static_argnames=("out_res",))
def sample_irradiance(env: jnp.ndarray, out_res: int = IRRADIANCE_RES):
    """(6, out_res, out_res, 3) cosine-convolved irradiance."""
    env = pack_cubemap_rows(env)  # once, outside the quadrature loop
    n = face_directions(out_res)  # (6,S,S,3) normals
    up = jnp.where(
        (jnp.abs(n[..., 1]) < 0.99)[..., None],
        jnp.array([0.0, 1.0, 0.0]),
        jnp.array([1.0, 0.0, 0.0]),
    )
    right = jnp.cross(up, n)
    right = right / jnp.linalg.norm(right, axis=-1, keepdims=True)
    up2 = jnp.cross(n, right)

    phi_steps, theta_steps = 128, 64

    def body(k, acc):
        j = k // phi_steps
        i = k % phi_steps
        theta = 0.5 * jnp.pi * j.astype(jnp.float32) / theta_steps
        phi = 2.0 * jnp.pi * i.astype(jnp.float32) / phi_steps
        ts = jnp.stack(
            [jnp.sin(theta) * jnp.cos(phi), jnp.sin(theta) * jnp.sin(phi), jnp.cos(theta)]
        )
        sv = ts[0] * right + ts[1] * up2 + ts[2] * n
        s = jnp.minimum(sample_cubemap(env, sv), 10.0)
        return acc + s * (jnp.cos(theta) * jnp.sin(theta))

    acc = jax.lax.fori_loop(0, phi_steps * theta_steps, body, jnp.zeros_like(n))
    return jnp.pi * acc / (phi_steps * theta_steps)


@partial(jax.jit, static_argnames=("alpha", "n_samples"))
def _prefilter_mip(env: jnp.ndarray, n: jnp.ndarray, alpha: float, n_samples: int):
    env = pack_cubemap_rows(env)  # once, outside the sample loop

    def body(i, cw):
        xi = hammersley(jnp.full((), i, jnp.uint32), n_samples)
        h = importance_sample_ibl_trowbridge_reitz(xi, jnp.full(n.shape[:-1], alpha), n)
        l = 2.0 * jnp.sum(n * h, -1, keepdims=True) * h - n
        nol = saturate(jnp.sum(n * l, -1))
        s = jnp.minimum(sample_cubemap(env, l), 10.0)
        return (
            cw[0] + s * nol[..., None],
            cw[1] + nol,
        )

    color, weight = jax.lax.fori_loop(
        0, n_samples, body, (jnp.zeros_like(n), jnp.zeros(n.shape[:-1]))
    )
    return color / jnp.maximum(weight[..., None], 1e-4)


def prefilter_radiance(env: jnp.ndarray, res: int = 128, n_mips: int = 8, n_samples: int = 256):
    """List of (6, res>>m, res>>m, 3) GGX-prefiltered mips (Karis).

    One jit call per mip, with the face-direction grid passed as an
    argument: compiling all mips into a single program once miscompiled
    on an earlier XLA backend (mips 3-6 came back NaN on the -x/-y/±z
    faces; the identical per-mip program is bit-clean). Prefiltering is
    a one-time build step, so per-mip dispatch costs nothing.
    """
    mips = []
    for m in range(n_mips):
        r = max(res >> m, 1)
        roughness = m / max(n_mips - 1, 1)
        mips.append(
            _prefilter_mip(env, face_directions(r), roughness * roughness, n_samples)
        )
    return mips


def sample_prefiltered(mips: list, d: jnp.ndarray, lod: jnp.ndarray):
    """Trilinear-across-mips prefiltered radiance fetch."""
    n = len(mips)
    lod = jnp.clip(lod, 0.0, n - 1.0)
    m0 = jnp.floor(lod)
    f = (lod - m0)[..., None]
    out = jnp.zeros(d.shape[:-1] + (3,))
    for m in range(n):
        s = sample_cubemap(mips[m], d)
        sel0 = (m0 == m)[..., None]
        sel1 = (m0 == m - 1)[..., None]
        out = out + jnp.where(sel0, s * (1 - f), 0.0) + jnp.where(sel1, s * f, 0.0)
    return out


def eval_ibl(surface: dict, ibl: dict) -> jnp.ndarray:
    """skybox.glsl evalIBL: split-sum diffuse + specular."""
    f0 = fresnel_zero(surface["albedo"], surface["metallic"])
    NoV = surface["NoV"]
    F = schlick_fresnel_with_roughness(NoV, f0, surface["roughness"])
    kd = (1.0 - F) * (1.0 - surface["metallic"])[..., None]

    irradiance = sample_cubemap(ibl["irradiance"], surface["normal_ws"])
    diffuse = irradiance * surface["albedo"]

    r = surface["inv_view_ray"]
    refl = 2.0 * jnp.sum(r * surface["normal_ws"], -1, keepdims=True) * surface[
        "normal_ws"
    ] - r
    n_mips = len(ibl["radiance_mips"])
    lod = surface["roughness"] * MAX_REFLECTION_LOD
    lod = jnp.clip(lod, 0.0, n_mips - 1.0)
    prefiltered = sample_prefiltered(ibl["radiance_mips"], refl, lod)

    lut = ibl["brdf_lut"]
    res = lut.shape[0]
    xi = jnp.clip((NoV * res).astype(jnp.int32), 0, res - 1)
    yi = jnp.clip((surface["roughness"] * res).astype(jnp.int32), 0, res - 1)
    env_brdf = lut[yi, xi]
    specular = prefiltered * (F * env_brdf[..., 0:1] + env_brdf[..., 1:2])

    return kd * diffuse + specular


def build_ibl(env: jnp.ndarray) -> dict:
    """One-time IBL generation (Renderer.cpp:380-382)."""
    return {
        "brdf_lut": integrate_specular_brdf(),
        "irradiance": sample_irradiance(env),
        "radiance_mips": prefilter_radiance(env),
    }
