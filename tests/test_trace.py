"""Traversal correctness: tiled cluster tracing vs brute-force Möller."""

import numpy as np
import jax.numpy as jnp

from prosper_tpu.ops import trace
from prosper_tpu.testing import brute_force_closest as _brute_force
from prosper_tpu.testing import random_cluster_soup as _random_scene


def test_trace_closest_matches_brute_force():
    tris, wc_min, wc_max = _random_scene()
    rng = np.random.default_rng(1)
    R = trace.TILE * 2
    o = rng.uniform(-8, 8, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    hit = trace.trace_closest(
        tris, wc_min, wc_max, jnp.asarray(o), jnp.asarray(d), 1e-4, np.inf
    )
    want_tri, want_t = _brute_force(tris, o, d, 1e-4, np.inf)

    got_tri = np.asarray(hit["tri"])
    got_t = np.asarray(hit["t"])
    # Same hit triangle (modulo exact ties) and same t
    miss = want_tri < 0
    np.testing.assert_array_equal(got_tri < 0, miss)
    sel = ~miss
    np.testing.assert_allclose(got_t[sel], want_t[sel], rtol=1e-5, atol=1e-6)
    # allow differing tri index only for equal-t ties
    diff = sel & (got_tri != want_tri)
    assert np.allclose(got_t[diff], want_t[diff], rtol=1e-5)


def test_trace_any_matches_brute_force():
    tris, wc_min, wc_max = _random_scene(seed=3)
    rng = np.random.default_rng(4)
    R = trace.TILE
    o = rng.uniform(-8, 8, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = 5.0

    occluded = trace.trace_any(
        tris, wc_min, wc_max, jnp.asarray(o), jnp.asarray(d), 1e-4, t_max
    )
    want_tri, _ = _brute_force(tris, o, d, 1e-4, t_max)
    np.testing.assert_array_equal(np.asarray(occluded), want_tri >= 0)


def test_coherent_tile_rays():
    """Primary-like rays from one origin through a grid."""
    tris, wc_min, wc_max = _random_scene(n_clusters=8, seed=7)
    R = trace.TILE
    o = np.tile(np.array([0, 0, 12.0], np.float32), (R, 1))
    xs = np.linspace(-0.4, 0.4, 16)
    dirs = np.stack(
        [np.repeat(xs, 16), np.tile(xs, 16), -np.ones(R)], axis=1
    ).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    hit = trace.trace_closest(
        tris, wc_min, wc_max, jnp.asarray(o), jnp.asarray(dirs), 1e-4, np.inf
    )
    want_tri, want_t = _brute_force(tris, o, dirs, 1e-4, np.inf)
    got_t = np.asarray(hit["t"])
    sel = want_tri >= 0
    np.testing.assert_array_equal(np.asarray(hit["tri"]) >= 0, sel)
    np.testing.assert_allclose(got_t[sel], want_t[sel], rtol=1e-5, atol=1e-6)
