"""IBL: cubemap addressing roundtrip, split-sum LUT properties,
irradiance/prefilter energy sanity, evalIBL parity shape."""

import numpy as np
import jax.numpy as jnp

from prosper_tpu.ops import ibl


def test_cubemap_roundtrip():
    """Sampling along each texel's own direction returns that texel."""
    S = 16
    dirs = ibl.face_directions(S)
    rng = np.random.default_rng(0)
    cube = jnp.asarray(rng.random((6, S, S, 3), dtype=np.float32))
    got = ibl.sample_cubemap(cube, dirs)
    # interior texels are exact (bilinear at centers); edges blend
    err = np.abs(np.asarray(got) - np.asarray(cube))[:, 2:-2, 2:-2]
    assert err.max() < 1e-5, err.max()


def test_specular_brdf_lut():
    lut = np.asarray(ibl.integrate_specular_brdf(res=64, n_samples=128))
    assert lut.shape == (64, 64, 2)
    assert (lut >= 0).all() and (lut <= 1).all()
    # at low roughness / high NoV, A -> ~1 and B -> small
    assert lut[1, -1, 0] > 0.9
    assert lut[1, -1, 1] < 0.1


def test_irradiance_of_uniform_env_is_uniform():
    env = jnp.ones((6, 32, 32, 3)) * 2.0
    irr = np.asarray(ibl.sample_irradiance(env, out_res=8))
    # cosine-convolved uniform radiance L: E = pi * L ... normalized by
    # the quadrature the reference uses; just assert uniformity + positive
    assert irr.std() / irr.mean() < 0.02
    assert irr.mean() > 0


def test_prefilter_mip0_matches_env_roughly():
    # sun-free sky: the prefilter clamps samples at 10 (reference
    # behavior), which would decorrelate the sun disk
    d32 = ibl.face_directions(32)
    env = jnp.clip(jnp.asarray(ibl.procedural_sky(32)), 0.0, 2.0)
    mips = ibl.prefilter_radiance(env, res=16, n_mips=3, n_samples=32)
    assert len(mips) == 3
    # mip 0 (roughness 0) should correlate strongly with the env itself
    d = ibl.face_directions(16)
    direct = np.asarray(ibl.sample_cubemap(env, d))
    m0 = np.asarray(mips[0])
    corr = np.corrcoef(direct.reshape(-1), m0.reshape(-1))[0, 1]
    assert corr > 0.95, corr


def test_eval_ibl_shapes_and_energy():
    env = jnp.asarray(ibl.procedural_sky(32))
    data = {
        "brdf_lut": ibl.integrate_specular_brdf(res=32, n_samples=64),
        "irradiance": ibl.sample_irradiance(env, out_res=8),
        "radiance_mips": ibl.prefilter_radiance(env, res=16, n_mips=3, n_samples=32),
    }
    R = 64
    rng = np.random.default_rng(1)
    n = rng.normal(size=(R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    surface = {
        "normal_ws": jnp.asarray(n),
        "inv_view_ray": jnp.asarray(n),  # view along normal
        "albedo": jnp.full((R, 3), 0.5),
        "roughness": jnp.full((R,), 0.5),
        "metallic": jnp.zeros((R,)),
        "NoV": jnp.ones((R,)),
    }
    out = np.asarray(ibl.eval_ibl(surface, data))
    assert out.shape == (R, 3)
    assert (out >= 0).all() and np.isfinite(out).all()
    assert out.mean() > 0.01  # sky contributes energy


def test_prefilter_all_mips_finite():
    """Every prefiltered mip must be finite on every face.

    Regression: compiling all mips into one jit program once miscompiled
    (NaN on the -x/-y/+-z faces of mips 3-6);
    prefilter_radiance now dispatches one jit call per mip.
    """
    import numpy as np
    from prosper_tpu.ops.ibl import prefilter_radiance, procedural_sky

    mips = prefilter_radiance(procedural_sky(32), res=32, n_mips=6, n_samples=64)
    assert len(mips) == 6
    for m, mip in enumerate(mips):
        a = np.asarray(mip)
        assert np.isfinite(a).all(), f"mip {m} has non-finite texels"


def test_sample_cubemap_quad_rows_match_corner_gathers():
    """The quad-packed row fetch (one gather) must equal the naive
    4-corner bilinear fetch it replaced."""
    import numpy as np
    import jax.numpy as jnp

    from prosper_tpu.ops.ibl import sample_cubemap

    rng = np.random.default_rng(11)
    S = 16
    cube = jnp.asarray(rng.random((6, S, S, 3), dtype=np.float32))
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = np.asarray(sample_cubemap(cube, jnp.asarray(d)))

    # naive reference reproducing the pre-pack math
    cnp = np.asarray(cube)
    ax = np.abs(d)
    major = np.argmax(ax, axis=-1)
    pos = np.take_along_axis(d, major[:, None], axis=-1)[:, 0] >= 0
    face = major * 2 + np.where(pos, 0, 1)
    m = np.maximum(np.take_along_axis(ax, major[:, None], axis=-1)[:, 0], 1e-20)
    xn, yn, zn = d[:, 0] / m, d[:, 1] / m, d[:, 2] / m
    u = np.where(face == 0, -zn, np.where(face == 1, zn, np.where(face == 5, -xn, xn)))
    v = np.where(face == 2, zn, np.where(face == 3, -zn, -yn))
    uu = (u * 0.5 + 0.5) * S - 0.5
    vv = (v * 0.5 + 0.5) * S - 0.5
    x0 = np.floor(uu); y0 = np.floor(vv)
    fu = (uu - x0)[:, None]; fv = (vv - y0)[:, None]

    def g(yi, xi):
        yi = np.clip(yi.astype(np.int32), 0, S - 1)
        xi = np.clip(xi.astype(np.int32), 0, S - 1)
        return cnp[face, yi, xi]

    want = (
        g(y0, x0) * (1 - fu) * (1 - fv)
        + g(y0, x0 + 1) * fu * (1 - fv)
        + g(y0 + 1, x0) * (1 - fu) * fv
        + g(y0 + 1, x0 + 1) * fu * fv
    )
    assert np.allclose(got, want, atol=1e-6), np.abs(got - want).max()
