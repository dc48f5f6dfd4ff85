"""Stochastic-alpha any-hit parity: rays must pass through failed-mask
surfaces and probabilistically through blend surfaces (scene.rahit)."""

import numpy as np
import jax.numpy as jnp

from prosper_tpu.ops.texture import pack_material_tables, sample_alpha_packed
from prosper_tpu.testing import make_test_scene


def _dev(tree):
    return {
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in tree.items()
    }


def test_sample_alpha_signalling():
    static, frame, arena, _ = make_test_scene()
    static, arena = _dev(static), _dev(arena)
    mats = dict(static["materials"])
    # material 0 opaque, 1 masked with cutoff .5 and base alpha 1 (passes),
    # extend with 2: masked failing (factor alpha 0.2 < cutoff),
    # 3: blend alpha 0.3
    import numpy as np_

    bc = np_.array(
        [[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 0.2], [1, 1, 1, 0.3]], np_.float32
    )
    mats2 = {
        "base_color_factor": jnp.asarray(bc),
        "metallic_factor": jnp.ones(4),
        "roughness_factor": jnp.ones(4),
        "alpha_cutoff": jnp.full(4, 0.5),
        "alpha_mode": jnp.asarray([0, 1, 1, 2], jnp.int32),
        "base_color_tex": jnp.zeros(4, jnp.int32),
        "metallic_roughness_tex": jnp.zeros(4, jnp.int32),
        "normal_tex": jnp.zeros(4, jnp.int32),
    }
    arena = dict(arena)
    arena["mat_f32"], arena["mat_i32"] = pack_material_tables(mats2, arena)
    uv = jnp.zeros((4, 2))
    a = np.asarray(
        sample_alpha_packed(arena, jnp.asarray([0, 1, 2, 3], jnp.int32), uv)
    )
    assert a[0] == -1.0  # opaque
    assert a[1] == -1.0  # mask passes -> opaque signal
    assert a[2] == 0.0  # mask fails
    np.testing.assert_allclose(a[3], 0.3, atol=1e-6)  # blend alpha


def test_alpha_retrace_passes_through_masked_surface():
    """A fully-transparent (failed-mask) box in front of an opaque box:
    with alpha_rounds the ray must land on the opaque box behind."""
    from prosper_tpu.render.pt import pt_trace_pixels

    static, frame, arena, cam_fn = make_test_scene(n_boxes=4)
    static, frame, arena = _dev(static), _dev(frame), _dev(arena)

    # make material 1 a failing mask everywhere
    mats = {k: np.array(v) for k, v in static["materials"].items()}
    mats["alpha_mode"] = np.array([0, 1], np.int32)
    mats["base_color_factor"] = np.array(
        [[1, 1, 1, 1], [1, 1, 1, 0.0]], np.float32
    )
    static = dict(static)
    static["materials"] = {k: jnp.asarray(v) for k, v in mats.items()}
    arena = dict(arena)
    arena["mat_f32"], arena["mat_i32"] = pack_material_tables(
        static["materials"], arena
    )

    W = H = 16
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}
    px = jnp.tile(jnp.arange(W, dtype=jnp.uint32), H)
    py = jnp.repeat(jnp.arange(H, dtype=jnp.uint32), W)
    res = jnp.array([W, H], jnp.int32)

    # the plain tracer's hits carry (t, tri, u, v) only; the retrace loop
    # gathers material and uv after the trace
    color_a, _ = pt_trace_pixels(
        static, frame, arena, cam, px, py, res, 0, max_bounces=1,
        alpha_rounds=2,
    )
    color_b, _ = pt_trace_pixels(
        static, frame, arena, cam, px, py, res, 0, max_bounces=1,
        alpha_rounds=0,
    )
    # with all surfaces failed-mask, alpha retrace must change the image:
    # rounds=0 shades the (invalid-alpha) front surface as black via the
    # alpha==0 guard; rounds=2 passes through everything, so all rays
    # exit -> pure background (zero) everywhere
    a = np.asarray(color_a)
    b = np.asarray(color_b)
    assert a.sum() == 0.0  # all surfaces transparent -> no light at all
    assert np.isfinite(b).all()


def test_alpha_retrace_reaches_surface_behind_blend():
    """A half-transparent blend material: the stochastic any-hit keeps
    some hits and passes others, so the retraced image differs from the
    opaque one and stays finite."""
    from prosper_tpu.render.pt import pt_trace_pixels

    static, frame, arena, cam_fn = make_test_scene(n_boxes=4)
    static, frame, arena = _dev(static), _dev(frame), _dev(arena)
    mats = {k: np.array(v) for k, v in static["materials"].items()}
    mats["alpha_mode"] = np.array([0, 2], np.int32)
    mats["base_color_factor"] = np.array(
        [[1, 1, 1, 1], [0.8, 0.4, 0.3, 0.5]], np.float32
    )
    static = dict(static)
    static["materials"] = {k: jnp.asarray(v) for k, v in mats.items()}
    arena = dict(arena)
    arena["mat_f32"], arena["mat_i32"] = pack_material_tables(
        static["materials"], arena
    )
    W = H = 16
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}
    px = jnp.tile(jnp.arange(W, dtype=jnp.uint32), H)
    py = jnp.repeat(jnp.arange(H, dtype=jnp.uint32), W)
    res = jnp.array([W, H], jnp.int32)
    opaque, _ = pt_trace_pixels(
        static, frame, arena, cam, px, py, res, 0, max_bounces=1,
    )
    blended, _ = pt_trace_pixels(
        static, frame, arena, cam, px, py, res, 0, max_bounces=1,
        alpha_rounds=2,
    )
    opaque, blended = np.asarray(opaque), np.asarray(blended)
    assert np.isfinite(blended).all()
    assert not np.allclose(opaque, blended)


def _masked_scene(n_boxes=4):
    static, frame, arena, cam_fn = make_test_scene(n_boxes=n_boxes)
    # every cluster uses material 1: make it a failing mask (cut-out
    # everywhere -> discard must reveal the background)
    mats = {k: np.array(v) for k, v in static["materials"].items()}
    mats["alpha_mode"][1] = 1
    mats["base_color_factor"][1, 3] = 0.0
    static = dict(static)
    static["materials"] = mats
    static, frame, arena = _dev(static), _dev(frame), _dev(arena)
    arena = dict(arena)
    from prosper_tpu.ops.texture import pack_material_tables as _pack

    arena["mat_f32"], arena["mat_i32"] = _pack(static["materials"], arena)
    return static, frame, arena, cam_fn


def test_mask_discard_gbuffer():
    """gbuffer.frag:61-63 parity: failed-mask fragments are discarded —
    the G-buffer must show background through the cut-outs (deferred and
    ReSTIR share this path)."""
    from prosper_tpu.render.gbuffer import render_gbuffer

    static, frame, arena, cam_fn = _masked_scene()
    W = H = 32
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}
    g0 = render_gbuffer(static, frame, arena, cam, W, H, alpha_rounds=0)
    g2 = render_gbuffer(static, frame, arena, cam, W, H, alpha_rounds=2)
    v0 = np.asarray(g0["valid"])
    v2 = np.asarray(g2["valid"])
    assert v0.sum() > 0  # without discard the cut-out shades opaque
    assert v2.sum() == 0  # with discard every masked hit is skipped


def test_mask_discard_forward():
    """forward.frag:56-58 parity: the forward image with discard is the
    pure background (every surface is a failed mask)."""
    from prosper_tpu.render.forward import render_forward
    from prosper_tpu.ops.tonemap import generated_lut

    static, frame, arena, cam_fn = _masked_scene()
    W = H = 32
    cam = {k: jnp.asarray(v) for k, v in cam_fn(W, H).items()}
    lut = jnp.asarray(generated_lut())
    img0 = np.asarray(
        render_forward(static, frame, arena, cam, lut, W, H, alpha_rounds=0)
    )
    img2 = np.asarray(
        render_forward(static, frame, arena, cam, lut, W, H, alpha_rounds=2)
    )
    # discard removes every hit -> constant background image
    assert np.allclose(img2, img2.reshape(-1, 3)[0])
    assert not np.allclose(img0, img0.reshape(-1, 3)[0])
