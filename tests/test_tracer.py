"""The renderer's tracers, reached through the one backend decision
(ops/trace.make_tracer / tracer_kind), against brute-force Möller.

Every case runs the plain XLA tracer here; the same cases run the CUDA
BVH tracer on a GPU (`python -m pytest tests/ -m gpu`)."""

import numpy as np
import jax.numpy as jnp
import pytest

from prosper_tpu.accel.bvh import build_bvh, pack_nodes
from prosper_tpu.ops import trace
from prosper_tpu.testing import brute_force_closest as _brute_force
from prosper_tpu.testing import random_cluster_soup as _random_scene

KINDS = ["plain", pytest.param("cuda", marks=pytest.mark.gpu)]


@pytest.fixture
def kind(request):
    if request.param == "cuda":
        request.getfixturevalue("gpu_backend")
    with trace.forced_tracer(request.param):
        yield request.param


def _scene(n_clusters, seed):
    """(static, frame) dicts for make_tracer over a random cluster scene."""
    tris, wc_min, wc_max = _random_scene(n_clusters=n_clusters, seed=seed)
    bvh = build_bvh(np.asarray(wc_min), np.asarray(wc_max), max_leaf_size=1)
    bounds, meta = pack_nodes(bvh)
    count = (np.abs(np.asarray(tris["e1"])).sum(-1) > 0).reshape(
        n_clusters, trace.CLUSTER_PAD
    ).sum(-1)
    static = {"wc_tri_count": jnp.asarray(count, jnp.int32)}
    frame = {
        "geom": {"tris": tris},
        "wc_aabb_min_w": wc_min,
        "wc_aabb_max_w": wc_max,
        "bvh_bounds": jnp.asarray(bounds),
        "bvh_meta": jnp.asarray(meta),
    }
    return tris, static, frame


def _rays(seed, R):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("kind", KINDS, indirect=True)
@pytest.mark.parametrize("seed", [0, 7])
def test_closest_matches_brute_force(kind, seed):
    tris, static, frame = _scene(6, seed)
    o, d = _rays(seed + 1, trace.TILE * 2)
    got = trace.make_tracer(static, frame).closest(
        jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.inf
    )
    want_tri, want_t = _brute_force(tris, o, d, 1e-4, np.inf)
    got_tri, got_t = np.asarray(got["tri"]), np.asarray(got["t"])
    np.testing.assert_array_equal(got_tri < 0, want_tri < 0)
    sel = want_tri >= 0
    np.testing.assert_allclose(got_t[sel], want_t[sel], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS, indirect=True)
def test_closest_single_cluster_root_leaf(kind):
    tris, static, frame = _scene(1, 5)
    o, d = _rays(6, trace.TILE)
    got = trace.make_tracer(static, frame).closest(
        jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.inf
    )
    want_tri, _ = _brute_force(tris, o, d, 1e-4, np.inf)
    np.testing.assert_array_equal(np.asarray(got["tri"]) < 0, want_tri < 0)


@pytest.mark.parametrize("kind", KINDS, indirect=True)
def test_closest_finite_tmax_and_dead_rays(kind):
    """Per-ray t_max is respected; rays with t_max = 0 never hit."""
    tris, static, frame = _scene(4, 2)
    R = trace.TILE * 2
    o, d = _rays(3, R)
    t_max = np.full((R,), 6.0, np.float32)
    t_max[trace.TILE:] = 0.0
    got = trace.make_tracer(static, frame).closest(
        jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.asarray(t_max)
    )
    want_tri, _ = _brute_force(tris, o, d, 1e-4, 6.0)
    got_tri = np.asarray(got["tri"])
    live = np.arange(R) < trace.TILE
    np.testing.assert_array_equal(got_tri[live] < 0, want_tri[live] < 0)
    assert (got_tri[~live] < 0).all()
    # a miss reports t = t_max
    np.testing.assert_array_equal(np.asarray(got["t"])[~live], 0.0)


@pytest.mark.parametrize("kind", KINDS, indirect=True)
def test_any_matches_brute_force(kind):
    tris, static, frame = _scene(5, 3)
    o, d = _rays(4, trace.TILE)
    occ = trace.make_tracer(static, frame).any(
        jnp.asarray(o), jnp.asarray(d), 0.1, 6.0
    )
    want_tri, _ = _brute_force(tris, o, d, 0.1, 6.0)
    np.testing.assert_array_equal(np.asarray(occ), want_tri >= 0)


def _visible_tris(tris, mask):
    pad = trace.CLUSTER_PAD
    C = mask.shape[0]
    return {
        k: np.asarray(v).reshape(C, pad, 3)[mask].reshape(-1, 3)
        for k, v in tris.items()
    }


@pytest.mark.parametrize("kind", KINDS, indirect=True)
def test_cluster_mask_culls_clusters(kind):
    """cluster_mask: masked clusters are never hit — the result equals a
    brute force over the visible clusters only (the draw-list analog of
    two-phase culling and the transparent pass)."""
    tris, static, frame = _scene(6, 9)
    o, d = _rays(10, trace.TILE * 2)
    mask = np.ones(6, bool)
    mask[[1, 4]] = False
    got = trace.make_tracer(static, frame).closest(
        jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.inf, jnp.asarray(mask)
    )
    want_tri, want_t = _brute_force(_visible_tris(tris, mask), o, d, 1e-4,
                                    np.inf)
    got_tri, got_t = np.asarray(got["tri"]), np.asarray(got["t"])
    np.testing.assert_array_equal(got_tri < 0, want_tri < 0)
    sel = want_tri >= 0
    np.testing.assert_allclose(got_t[sel], want_t[sel], rtol=1e-5, atol=1e-6)
    hit_cluster = got_tri[got_tri >= 0] // trace.CLUSTER_PAD
    assert not np.isin(hit_cluster, np.where(~mask)[0]).any()


@pytest.mark.parametrize("kind", KINDS, indirect=True)
def test_any_respects_cluster_mask(kind):
    tris, static, frame = _scene(6, 11)
    o, d = _rays(12, trace.TILE)
    mask = np.zeros(6, bool)
    mask[[0, 2, 3]] = True
    occ = trace.make_tracer(static, frame).any(
        jnp.asarray(o), jnp.asarray(d), 0.1, 8.0, jnp.asarray(mask)
    )
    want_tri, _ = _brute_force(_visible_tris(tris, mask), o, d, 0.1, 8.0)
    np.testing.assert_array_equal(np.asarray(occ), want_tri >= 0)


def test_tracer_kind_per_platform():
    assert trace.tracer_kind("cpu") == "plain"
    assert trace.tracer_kind("gpu") == "cuda"


def test_tracer_kind_default_is_this_platform():
    assert trace.tracer_kind() == "plain"  # the tests compute on the CPU


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no ray tracer for platform"):
        trace.tracer_kind(platform)


def test_forced_tracer_scopes_the_choice():
    with trace.forced_tracer("cuda"):
        assert trace.tracer_kind("cpu") == "cuda"
        with trace.forced_tracer("plain"):
            assert trace.tracer_kind("gpu") == "plain"
        assert trace.tracer_kind() == "cuda"
    assert trace.tracer_kind() == "plain"
    with pytest.raises(ValueError, match="unknown tracer"):
        with trace.forced_tracer("bogus"):
            pass


def test_make_tracer_on_cpu_is_the_plain_tracer():
    tris, static, frame = _scene(3, 1)
    o, d = _rays(2, trace.TILE)
    got = trace.make_tracer(static, frame).closest(
        jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.inf
    )
    want = trace.trace_closest(
        tris, frame["wc_aabb_min_w"], frame["wc_aabb_max_w"],
        jnp.asarray(o), jnp.asarray(d), 1e-4, jnp.inf,
    )
    for k in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("log_cos", [-5, -3, -1, 0])
def test_exact_hit_t_is_accurate_at_grazing_angles(log_cos):
    """exact_hit_t stays within a few ulps of the float64 plane distance
    at any angle, where Moller-Trumbore's float32 t loses ulp/|cos|: the
    CUDA tracer's float64 t and the plain tracer's agree on grazing hits."""
    from prosper_tpu.ops.intersect import exact_hit_t

    rng = np.random.default_rng(3)
    N = 4096
    v0 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    e1 = (rng.normal(size=(N, 3)) * 0.01).astype(np.float32)
    e2 = (rng.normal(size=(N, 3)) * 0.01).astype(np.float32)
    n = np.cross(e1.astype(np.float64), e2.astype(np.float64))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    a = rng.normal(size=(N, 3))
    a -= (a * n).sum(1, keepdims=True) * n
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    cos = 10.0 ** log_cos
    d = (a * np.sqrt(1 - cos**2) + n * cos).astype(np.float32)
    p = v0 + 0.3 * e1.astype(np.float64) + 0.3 * e2
    o = (p - d * rng.uniform(0.5, 2, (N, 1))).astype(np.float32)
    f64 = [x.astype(np.float64) for x in (o, d, v0, e1, e2)]
    nn = np.cross(f64[3], f64[4])
    want = ((f64[2] - f64[0]) * nn).sum(1) / (f64[1] * nn).sum(1)
    got = np.asarray(exact_hit_t(o, d, v0, e1, e2), np.float64)
    np.testing.assert_allclose(got, want, rtol=4e-7)

