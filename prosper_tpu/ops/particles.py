"""GPU particle system, functional formulation.

Parity with /root/reference/src/render/particles/ + res/shader/particles/:
- Particle state {position+lifetime, normal+spawnRate, velocity+spawnTimer,
  mask} (shared/shader_structs/particles/particle.h), fixed capacity
- Init: emitters spawned at a draw instance's world-space vertices with
  lifetime 0 (= immortal emitter), spawnRate .1, Emit mask (init.comp)
- Simulate: integrate velocity, gravity (9.81 * .01 drag) when the
  Gravity bit is set, lifetime decay when Decay is set; emitters steer
  velocity by normal + pcg noise, clamp speed to .05, and spawn a child
  (lifetime 4, Gravity|Decay) every spawnRate seconds (simulate.comp)
- Decay/freelist: the atomics+freelist allocator becomes prefix-sum slot
  allocation over the dead mask — same capacity semantics, no atomics
- Render: ~1px point splats, depth-tested against the G-buffer, 8x8
  Bayer dithered transparency (common/dither.glsl), drawn before TAA
  (Renderer.cpp:530-538)

The whole system is a `(state, dt, frame) -> state` pure function: the
reference's persistent SSBO becomes a donated pytree carried across
frames.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..mathx import rng as prng

MAX_PARTICLES = 1 << 14

MASK_EMIT = 1
MASK_GRAVITY = 2
MASK_DECAY = 4

_BAYER8 = (
    np.array(
        [
            [0, 32, 8, 40, 2, 34, 10, 42],
            [48, 16, 56, 24, 50, 18, 58, 26],
            [12, 44, 4, 36, 14, 46, 6, 38],
            [60, 28, 52, 20, 62, 30, 54, 22],
            [3, 35, 11, 43, 1, 33, 9, 41],
            [51, 19, 59, 27, 49, 17, 57, 25],
            [15, 47, 7, 39, 13, 45, 5, 37],
            [63, 31, 55, 23, 61, 29, 53, 21],
        ],
        np.float32,
    )
    / 64.0
)


def init_state(capacity: int = MAX_PARTICLES) -> dict:
    """Empty particle pool (lifetime -9999 = dead, particle.h default)."""
    return {
        "position_lifetime": jnp.full((capacity, 4), -9999.0, jnp.float32)
        .at[:, :3]
        .set(0.0),
        "normal_spawnrate": jnp.zeros((capacity, 4), jnp.float32),
        "velocity_spawntimer": jnp.zeros((capacity, 4), jnp.float32),
        "mask": jnp.zeros((capacity,), jnp.uint32),
    }


def _allocate(dead: jnp.ndarray, want: jnp.ndarray):
    """Prefix-sum slot allocation: the freelist-pop analog.

    dead: (N,) free slots; want: (M,) requests. Returns (slots (M,),
    granted (M,) bool) assigning the first free slots to the first
    requests (stable, like sequential freelist pops)."""
    free_rank = jnp.cumsum(dead.astype(jnp.int32)) - 1  # rank per slot
    n_free = dead.sum().astype(jnp.int32)
    req_rank = jnp.cumsum(want.astype(jnp.int32)) - 1
    granted = want & (req_rank < n_free)
    # slot for request rank r = index of the r-th free slot
    order = jnp.argsort(~dead, stable=True)  # free slots first
    slots = order[jnp.clip(req_rank, 0, dead.shape[0] - 1)]
    # un-granted requests scatter out of bounds -> dropped (otherwise a
    # denied request could overwrite a granted one's slot)
    slots = jnp.where(granted, slots, dead.shape[0])
    return slots, granted


def spawn_emitters(state: dict, positions: jnp.ndarray, normals: jnp.ndarray) -> dict:
    """Init pass: emitters at world-space vertices (init.comp:47-58)."""
    n = positions.shape[0]
    dead = state["position_lifetime"][:, 3] < 0.0
    slots, granted = _allocate(dead, jnp.ones((n,), bool))

    def scat(arr, vals):
        return arr.at[slots].set(jnp.where(granted[:, None], vals, arr[slots]))

    pl = jnp.concatenate([positions, jnp.zeros((n, 1))], axis=1)
    ns = jnp.concatenate([normals, jnp.full((n, 1), 0.1)], axis=1)
    state = dict(state)
    state["position_lifetime"] = scat(state["position_lifetime"], pl)
    state["normal_spawnrate"] = scat(state["normal_spawnrate"], ns)
    state["velocity_spawntimer"] = scat(
        state["velocity_spawntimer"], jnp.zeros((n, 4))
    )
    state["mask"] = state["mask"].at[slots].set(
        jnp.where(granted, jnp.uint32(MASK_EMIT), state["mask"][slots])
    )
    return state


@partial(jax.jit, donate_argnums=(0,))
def simulate(state: dict, dt, frame_index) -> dict:
    """Simulate + decay (simulate.comp + decay.comp), one fused step."""
    cap = state["mask"].shape[0]
    pl = state["position_lifetime"]
    ns = state["normal_spawnrate"]
    vs = state["velocity_spawntimer"]
    mask = state["mask"]

    alive = pl[:, 3] >= 0.0
    pos = pl[:, :3]
    lifetime = pl[:, 3]
    vel = vs[:, :3]
    spawn_timer = vs[:, 3]

    idx = jnp.arange(cap, dtype=jnp.uint32)
    st = prng.make_state(idx, idx % 64, jnp.uint32(frame_index))

    pos = pos + vel * dt
    gravity = (mask & MASK_GRAVITY) != 0
    vel = vel.at[:, 1].add(jnp.where(gravity, -9.81 * 0.01 * dt, 0.0))
    decay = (mask & MASK_DECAY) != 0
    lifetime = jnp.where(decay & alive, lifetime - dt, lifetime)

    # emitters steer + spawn (simulate.comp:60-90)
    emit = ((mask & MASK_EMIT) != 0) & alive
    st, r3 = prng.rnd3d01(st)
    v2 = vel + (ns[:, :3] + r3 * 2.0 - 1.0) * 0.5 * dt
    speed = jnp.linalg.norm(v2, axis=1, keepdims=True)
    v2 = v2 / jnp.maximum(speed, 1e-9) * jnp.minimum(speed, 0.05)
    vel = jnp.where(emit[:, None], v2, vel)
    new_normal = v2 / jnp.maximum(jnp.linalg.norm(v2, axis=1, keepdims=True), 1e-9)
    ns = jnp.where(emit[:, None], jnp.concatenate([new_normal, ns[:, 3:]], 1), ns)

    spawn_timer = jnp.where(emit, spawn_timer + dt, spawn_timer)
    wants_child = emit & (spawn_timer >= ns[:, 3])
    spawn_timer = jnp.where(wants_child, 0.0, spawn_timer)

    # kill expired first so their slots are reusable (decay pass order)
    lifetime = jnp.where(decay & (lifetime < 0.0), -9999.0, lifetime)
    dead = lifetime < 0.0

    slots, granted = _allocate(dead, wants_child)
    child_pl = jnp.concatenate([pos, jnp.full((cap, 1), 4.0)], 1)
    child_ns = jnp.concatenate([new_normal, jnp.full((cap, 1), 0.0)], 1)
    child_vs = jnp.concatenate(
        [new_normal * 0.02, jnp.zeros((cap, 1))], 1
    )

    def scat(arr, vals):
        return arr.at[slots].set(jnp.where(granted[:, None], vals, arr[slots]))

    pl_new = jnp.concatenate([pos, lifetime[:, None]], 1)
    pl_new = scat(pl_new, child_pl)
    ns = scat(ns, child_ns)
    vs_new = jnp.concatenate([vel, spawn_timer[:, None]], 1)
    vs_new = scat(vs_new, child_vs)
    mask = mask.at[slots].set(
        jnp.where(granted, jnp.uint32(MASK_GRAVITY | MASK_DECAY), mask[slots])
    )

    return {
        "position_lifetime": pl_new,
        "normal_spawnrate": ns,
        "velocity_spawntimer": vs_new,
        "mask": mask,
    }


def render_particles(
    state: dict,
    hdr: jnp.ndarray,  # (H, W, 3)
    depth: jnp.ndarray,  # (H, W) reverse-z
    cam: dict,
    color=(1.0, 0.8, 0.4),
    alpha: float = 0.6,
) -> jnp.ndarray:
    """Depth-tested dithered point splats over the HDR frame."""
    h, w = hdr.shape[:2]
    pl = state["position_lifetime"]
    alive = pl[:, 3] >= 0.0
    ph = jnp.concatenate([pl[:, :3], jnp.ones((pl.shape[0], 1))], 1)
    clip = ph @ cam["world_to_clip"].T
    behind = clip[:, 3] <= 1e-6
    ndc = clip[:, :3] / jnp.where(behind, 1.0, clip[:, 3])[:, None]
    x = ((ndc[:, 0] * 0.5 + 0.5) * w).astype(jnp.int32)
    y = ((ndc[:, 1] * 0.5 + 0.5) * h).astype(jnp.int32)
    on_screen = (x >= 0) & (x < w) & (y >= 0) & (y < h) & ~behind & alive

    xs = jnp.clip(x, 0, w - 1)
    ys = jnp.clip(y, 0, h - 1)
    # reverse-z depth test vs G-buffer
    scene_d = depth[ys, xs]
    visible = on_screen & (ndc[:, 2] >= scene_d)
    # 8x8 Bayer dithered alpha (dither.glsl)
    thresh = jnp.asarray(_BAYER8)[ys % 8, xs % 8]
    visible = visible & (alpha > thresh)

    col = jnp.asarray(color, jnp.float32)
    # invisible particles scatter out of bounds -> dropped (duplicate
    # pixel indices would otherwise let a dead particle overwrite a
    # visible one's splat)
    ys = jnp.where(visible, ys, h)
    return hdr.at[ys, xs].set(jnp.broadcast_to(col, (ys.shape[0], 3)))
