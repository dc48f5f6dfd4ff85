"""Anisotropic material filtering (maxAnisotropy=16 sampler parity,
WorldData.cpp:693-714): taps along the uv major axis must reconstruct an
elongated footprint better than the isotropic trilinear fallback."""

import numpy as np
import jax.numpy as jnp

from prosper_tpu.ops.texture import sample_aniso, sample_trilinear
from prosper_tpu.scene.textures import pack_rgba8_quads


def _stripe_arena(w=64, h=64, period=8):
    """Vertical stripes: structure only along u, constant along v, with
    a full mip chain so both samplers can pick their preferred level."""
    x = np.arange(w)
    img0 = np.zeros((h, w, 4), np.uint8)
    img0[..., :3] = np.where(((x // period) % 2 == 0)[None, :, None], 230, 30)
    img0[..., 3] = 255

    mips = [img0]
    cur = img0.astype(np.float32)
    while min(cur.shape[0], cur.shape[1]) > 1:
        cur = (
            cur.reshape(cur.shape[0] // 2, 2, cur.shape[1] // 2, 2, 4)
            .mean(axis=(1, 3))
        )
        mips.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))

    table = np.zeros((1, 13, 4), np.int32)
    chunks = []
    off = 0
    for m, mip in enumerate(mips):
        mh, mw = mip.shape[:2]
        table[0, m] = (off, mw, mh, 0)
        chunks.append(pack_rgba8_quads(mip))
        off += mh * mw
    for m in range(len(mips), 13):
        table[0, m] = table[0, len(mips) - 1]
    arena = {
        "data": jnp.asarray(np.concatenate(chunks).astype(np.uint32)),
        "table": jnp.asarray(table),
        "n_mips": jnp.full(1, len(mips), np.int32),
    }
    return arena, img0


def test_aniso_beats_trilinear_on_elongated_footprint():
    arena, img0 = _stripe_arena()
    rng = np.random.default_rng(0)
    R = 128
    uv = rng.uniform(0.2, 0.8, (R, 2)).astype(np.float32)
    tex = jnp.zeros(R, jnp.int32)

    # footprint: 8 texels long along v (the constant axis), 1 texel
    # along u -> the correct filter result is ~the u-local stripe color
    w = 64.0
    major = jnp.tile(jnp.asarray([[0.0, 8.0 / w]], jnp.float32), (R, 1))
    lod_minor = jnp.zeros((R,), jnp.float32)  # 1-texel minor axis
    lod_major = jnp.full((R,), 3.0, jnp.float32)  # log2(8): the
    # isotropic fallback must use the conservative (major) footprint

    got_aniso = np.asarray(
        sample_aniso(arena, tex, jnp.asarray(uv), major, lod_minor, 8)
    )[:, 0]
    got_tri = np.asarray(
        sample_trilinear(arena, tex, jnp.asarray(uv), lod_major)
    )[:, 0]

    # analytic ground truth: stripes are constant along v, so the true
    # footprint average is the mip-0 bilinear value at uv
    want = np.asarray(
        sample_trilinear(arena, tex, jnp.asarray(uv), jnp.zeros((R,)))
    )[:, 0]

    err_aniso = np.abs(got_aniso - want).mean()
    err_tri = np.abs(got_tri - want).mean()
    assert err_aniso < err_tri * 0.25, (err_aniso, err_tri)
    assert err_aniso < 0.02, err_aniso


def test_gbuffer_aniso_path_runs_and_matches_at_normal_incidence():
    """aniso_taps > 1 through the G-buffer: head-on surfaces (ratio ~1)
    must match the isotropic path closely; the pass must run end-to-end
    on the gather path."""
    import jax.numpy as jnp

    from prosper_tpu.render.gbuffer import render_gbuffer
    from prosper_tpu.testing import make_test_scene
    from prosper_tpu.ops.texture import pack_material_tables

    static, frame, arena, cam_fn = make_test_scene(n_boxes=4)
    dev = lambda t: {  # noqa: E731
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in t.items()
    }
    static, frame, arena = dev(static), dev(frame), dev(arena)
    arena["mat_f32"], arena["mat_i32"] = pack_material_tables(
        static["materials"], arena
    )
    W = H = 64
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}
    g1 = render_gbuffer(static, frame, arena, cam, W, H, aniso_taps=1)
    g4 = render_gbuffer(static, frame, arena, cam, W, H, aniso_taps=4)
    v = np.asarray(g1["valid"])
    a1 = np.asarray(g1["albedo_roughness"])[v]
    a4 = np.asarray(g4["albedo_roughness"])[v]
    # the 1px-white test texture is constant, so filtering cannot change
    # the answer — this pins the aniso plumbing (uv jacobian, lod) as
    # non-corrupting; real-texture quality is the texture-level test
    np.testing.assert_allclose(a4, a1, atol=1e-5)
