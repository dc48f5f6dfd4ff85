"""Tile-granular wavefront compaction for sparse per-pixel work.

A wavefront stand-in for the reference's implicit early-out: rather than
element-level scatters at 2M rows, TILE-level (256-lane) gathers and
scatters move whole tiles, and a prefix sum over R/256 tile flags is
cheap. `tile_apply` runs a per-lane function only on the
256-lane tiles where `mask` has any set lane, processing survivors in
fixed-capacity chunks with a dynamic lax.fori_loop trip count, and
scatters results back into zero-initialised full-size outputs.

Used by the ReSTIR stages (render/restir.py), where it measured faster
on the GPU than dense evaluation (PERF.md); the path tracer inlines the
same chunked compaction for its loop-carried state (render/pt.py). The
reference gets the same effect from rasterising only covered fragments /
early ray termination.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TILE = 256


def tile_apply(mask, fn, inputs, out_like=None, chunk_tiles: int = 512):
    """Apply `fn` to the 256-lane tiles of `inputs` selected by `mask`.

    mask: (R,) bool — lanes that need work; tiles with no set lane are
        skipped entirely.
    fn: (chunk_inputs: pytree of (C, ...) arrays, lane_mask: (C,) bool)
        -> pytree of (C, ...) arrays, C = chunk_tiles * 256.
    inputs: pytree of (R, ...) arrays (R must be a multiple of 256).
    out_like: pytree of ShapeDtypeStruct/arrays giving the per-lane
        output shapes ((R, ...)); derived with jax.eval_shape when None.
        Outputs are ZERO off-mask lanes — merge defaults with
        jnp.where(mask, ...) at the call site.

    Returns the (R, ...) output pytree.
    """
    leaves = jax.tree_util.tree_leaves(inputs)
    R = leaves[0].shape[0]
    assert R % TILE == 0, R
    n_tiles = R // TILE
    ct = min(chunk_tiles, n_tiles)

    tile_any = jnp.any(mask.reshape(n_tiles, TILE), axis=1)
    # Pad tidx to a ct multiple so the per-chunk dynamic_slice below never
    # clamps its start index (a clamped slice would overlap the previous
    # chunk and the .at[slc].add scatter would double-count those tiles).
    tidx_size = ((n_tiles + ct - 1) // ct) * ct
    tidx = jnp.nonzero(tile_any, size=tidx_size, fill_value=n_tiles)[
        0
    ].astype(jnp.int32)
    tcount = jnp.sum(tile_any.astype(jnp.int32))
    n_chunks = (tcount + ct - 1) // ct

    if out_like is None:
        chunk_in = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct((ct * TILE,) + a.shape[1:], a.dtype),
            inputs,
        )
        lane_in = jax.ShapeDtypeStruct((ct * TILE,), jnp.bool_)
        out_like = jax.eval_shape(fn, chunk_in, lane_in)

    # Loop-INVARIANT tiled views hoisted out of the body, and outputs
    # CARRIED in flat tile-row shape (n_tiles, 256*k): reshapes at a
    # fori_loop carry boundary materialize as full relayout copies every
    # iteration (measured 6.3 ms per vec3 field per chunk at 1080p in
    # the deferred frame's xplane), while the same reshape outside the
    # loop fuses for free.
    def _k(shape):
        k = 1
        for s in shape[1:]:
            k *= s
        return k

    inputs_t = jax.tree_util.tree_map(
        lambda a: a.reshape(n_tiles, TILE * _k(a.shape)), inputs
    )
    mask_t = mask.reshape(n_tiles, TILE)

    outs = jax.tree_util.tree_map(
        lambda s: jnp.zeros((n_tiles, TILE * _k(s.shape)), s.dtype), out_like
    )

    def chunk_body(ci, outs):
        sl = jax.lax.dynamic_slice(tidx, (ci * ct,), (ct,))
        tile_ok = sl < n_tiles
        slc = jnp.minimum(sl, n_tiles - 1)
        lane_ok = jnp.repeat(tile_ok, TILE) & mask_t[slc].reshape(ct * TILE)

        c_in = jax.tree_util.tree_map(
            lambda at, a: at[slc].reshape((ct * TILE,) + a.shape[1:]),
            inputs_t,
            inputs,
        )
        c_out = fn(c_in, lane_ok)

        def scat(o, c):
            c = jnp.where(
                lane_ok.reshape((ct * TILE,) + (1,) * (c.ndim - 1)), c, 0
            ).astype(o.dtype)
            c = c.reshape(ct, o.shape[1])
            if o.dtype == jnp.bool_:
                # chunk tiles are disjoint, so max == set; scatter-add
                # rejects bool
                return o.at[slc].max(c)
            return o.at[slc].add(c)

        return jax.tree_util.tree_map(scat, outs, c_out)

    outs = jax.lax.fori_loop(0, n_chunks, chunk_body, outs)
    return jax.tree_util.tree_map(
        lambda o, s: o.reshape((R,) + tuple(s.shape[1:])), outs, out_like
    )
