"""Particle system: allocation, simulation, decay, spawn, render."""

import numpy as np
import jax.numpy as jnp

from prosper_tpu.ops import particles as P


def test_spawn_emitters_allocates():
    s = P.init_state(64)
    pos = jnp.asarray(np.random.default_rng(0).random((8, 3)), jnp.float32)
    nrm = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (8, 1))
    s = P.spawn_emitters(s, pos, nrm)
    alive = np.asarray(s["position_lifetime"][:, 3] >= 0)
    assert alive.sum() == 8
    assert (np.asarray(s["mask"])[alive] == P.MASK_EMIT).all()


def test_allocation_respects_capacity():
    s = P.init_state(4)
    pos = jnp.zeros((10, 3))
    nrm = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (10, 1))
    s = P.spawn_emitters(s, pos, nrm)
    alive = np.asarray(s["position_lifetime"][:, 3] >= 0)
    assert alive.sum() == 4  # freelist exhausted like the reference


def test_simulate_integrates_and_decays():
    s = P.init_state(32)
    # one decaying moving particle
    s["position_lifetime"] = s["position_lifetime"].at[0].set(
        jnp.array([0.0, 0, 0, 1.0])
    )
    s["velocity_spawntimer"] = s["velocity_spawntimer"].at[0].set(
        jnp.array([1.0, 0, 0, 0])
    )
    s["mask"] = s["mask"].at[0].set(P.MASK_DECAY | P.MASK_GRAVITY)
    s2 = P.simulate(dict(s), 0.5, 1)
    pl = np.asarray(s2["position_lifetime"][0])
    np.testing.assert_allclose(pl[0], 0.5, atol=1e-6)  # moved
    np.testing.assert_allclose(pl[3], 0.5, atol=1e-6)  # decayed
    # gravity pulled velocity down
    assert float(s2["velocity_spawntimer"][0, 1]) < 0

    # run until death
    for f in range(2, 5):
        s2 = P.simulate(s2, 0.5, f)
    assert float(s2["position_lifetime"][0, 3]) < 0  # dead and recycled


def test_emitter_spawns_children():
    s = P.init_state(32)
    pos = jnp.zeros((1, 3))
    nrm = jnp.array([[0.0, 1.0, 0.0]])
    s = P.spawn_emitters(s, pos, nrm)
    for f in range(1, 8):
        s = P.simulate(s, 0.05, f)  # spawnRate .1 -> child every 2 steps
    alive = np.asarray(s["position_lifetime"][:, 3] >= 0)
    assert alive.sum() > 1  # children exist
    masks = np.asarray(s["mask"])[alive]
    assert ((masks & (P.MASK_GRAVITY | P.MASK_DECAY)) > 0).any()


def test_render_depth_test_and_dither():
    s = P.init_state(8)
    s["position_lifetime"] = s["position_lifetime"].at[0].set(
        jnp.array([0.0, 0.0, -2.0, 1.0])
    )
    cam = {
        "world_to_clip": jnp.asarray(
            np.array(
                [
                    [1, 0, 0, 0],
                    [0, 1, 0, 0],
                    [0, 0, 0, 0.5],  # constant reverse-z depth 0.25
                    [0, 0, -1, 0],
                ],
                np.float32,
            )
        )
    }
    hdr = jnp.zeros((16, 16, 3))
    depth_far = jnp.zeros((16, 16))  # reverse-z far
    out = np.asarray(P.render_particles(s, hdr, depth_far, cam, alpha=1.0))
    assert out.sum() > 0  # splatted
    depth_near = jnp.ones((16, 16))  # everything occluded
    out2 = np.asarray(P.render_particles(s, hdr, depth_near, cam, alpha=1.0))
    assert out2.sum() == 0


def test_deferred_threads_real_frame_index():
    """The per-frame pcg noise stream (simulate.comp parity) must
    advance: simulating the same state with different frame indices
    gives different spawn/steer noise (the deferred chain once pinned
    frame_index=0)."""
    import inspect

    from prosper_tpu.render import deferred as D

    # the entry must forward frame_index into render_deferred
    assert "frame_index" in inspect.signature(D.render_deferred).parameters

    s = P.init_state(64)
    pos = jnp.zeros((4, 3))
    nrm = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (4, 1))
    s = P.spawn_emitters(s, pos, nrm)
    # advance until children with noise-driven velocities exist
    for f in range(1, 8):
        s = P.simulate(s, 0.05, f)
    def copy(state):  # simulate donates its input buffers
        return {k: jnp.array(v) for k, v in state.items()}

    a = P.simulate(copy(s), 0.05, 100)
    b = P.simulate(copy(s), 0.05, 101)
    va = np.asarray(a["velocity_spawntimer"][:, :3])
    vb = np.asarray(b["velocity_spawntimer"][:, :3])
    assert not np.allclose(va, vb), "noise stream frozen across frames"
