"""Deferred path: clustered shading must equal brute-force all-lights
shading (culling must not change the image), G-buffer encodings round-trip."""

import numpy as np
import jax.numpy as jnp

from prosper_tpu.ops.clustering import (
    build_light_clusters,
    eval_clustered_lights,
    cluster_index_z,
    Z_SLICE_COUNT,
)
from prosper_tpu.render.forward import eval_all_lights
from prosper_tpu.render.shading import eval_directional_light
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


def _surface_grid(cam, width, height, lights, n_lights, seed=0):
    """Synthetic surfaces spread through the frustum + random lights."""
    rng = np.random.default_rng(seed)
    R = width * height
    # positions in front of the camera, scattered
    eye = np.asarray(cam["eye"])
    fwd = -np.asarray(cam["world_to_camera"])[2, :3]
    pos = (
        eye[None]
        + fwd[None] * rng.uniform(0.5, 30.0, (R, 1))
        + rng.normal(0, 2.0, (R, 3))
    ).astype(np.float32)
    n = rng.normal(size=(R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    inv_view = (eye[None] - pos).astype(np.float32)
    inv_view /= np.linalg.norm(inv_view, axis=1, keepdims=True)
    surface = {
        "position_ws": jnp.asarray(pos),
        "normal_ws": jnp.asarray(n),
        "inv_view_ray": jnp.asarray(inv_view),
        "albedo": jnp.full((R, 3), 0.7, jnp.float32),
        "roughness": jnp.full((R,), 0.4, jnp.float32),
        "metallic": jnp.zeros((R,), jnp.float32),
        "NoV": jnp.clip(jnp.sum(n * inv_view, axis=-1), 0, 1),
    }
    lights["point_position"][:n_lights] = eye[None] + fwd[None] * rng.uniform(
        1, 25, (n_lights, 1)
    ) + rng.normal(0, 3.0, (n_lights, 3))
    lights["point_radiance"][:n_lights] = rng.uniform(1, 10, (n_lights, 3))
    lights["point_radius"][:n_lights] = rng.uniform(2.0, 8.0, n_lights)
    lights["point_count"] = np.int32(n_lights)
    # packed_rows must be rebuilt after mutating the SoA (light_uniforms
    # does this for the normal frame path)
    from prosper_tpu.render.shading import pack_light_table
    import jax.numpy as jnp_

    lights["packed_rows"] = np.asarray(
        pack_light_table({k: jnp_.asarray(v) for k, v in lights.items() if k != "packed_rows"})
    )
    return surface, lights


def test_clustered_equals_brute_force():
    width = height = 64
    _, frame, _, cam_fn = make_test_scene()
    cam = {k: jnp.asarray(v) for k, v in cam_fn(width, height).items()}
    lights_np = {k: np.array(v) for k, v in frame["lights"].items()}
    surface, lights_np = _surface_grid(cam, width, height, lights_np, n_lights=40)
    lights = {k: jnp.asarray(v) for k, v in lights_np.items()}

    clusters = build_light_clusters(cam, lights, width, height)

    # pixel coords + view z per surface point
    w2c = np.asarray(cam["world_to_camera"])
    pos = np.asarray(surface["position_ws"])
    z_cam = pos @ w2c[2, :3] + w2c[2, 3]
    clip = np.concatenate([pos, np.ones((len(pos), 1))], 1) @ np.asarray(
        cam["world_to_clip"]
    ).T
    ndc = clip[:, :3] / clip[:, 3:4]
    px = np.clip(((ndc[:, 0] * 0.5 + 0.5) * width).astype(np.int32), 0, width - 1)
    py = np.clip(((ndc[:, 1] * 0.5 + 0.5) * height).astype(np.int32), 0, height - 1)
    # only keep surfaces inside the frustum with -z in [near, far]
    keep = (
        (np.abs(ndc[:, 0]) < 0.98)
        & (np.abs(ndc[:, 1]) < 0.98)
        & (z_cam < -float(cam["near"]))
        & (z_cam > -float(cam["far"]))
        & (clip[:, 3] > 0)
    )

    got = np.asarray(
        eval_clustered_lights(
            surface,
            lights,
            clusters,
            jnp.asarray(px),
            jnp.asarray(py),
            jnp.asarray(z_cam.astype(np.float32)),
            cam["near"],
            cam["far"],
        )
    )
    # brute force: all lights, no culling
    want = np.asarray(eval_all_lights(surface, lights)) - np.asarray(
        eval_directional_light(surface, lights)
    )
    np.testing.assert_allclose(got[keep], want[keep], rtol=2e-4, atol=1e-5)


def test_cluster_z_slices_monotonic():
    near, far = jnp.float32(0.1), jnp.float32(100.0)
    z = -jnp.logspace(-1, 2, 50)  # view-space z from -0.1 to -100
    s = np.asarray(cluster_index_z(z, near, far))
    assert s.min() >= 0 and s.max() <= Z_SLICE_COUNT - 1
    assert (np.diff(s) >= 0).all()


def test_gbuffer_encodings_roundtrip():
    from prosper_tpu.render.gbuffer import render_gbuffer
    from prosper_tpu.mathx.packing import signed_oct_decode

    static, frame, arena, cam_fn = make_test_scene()
    width = height = 32
    cam = {k: jnp.asarray(v) for k, v in cam_fn(width, height).items()}
    gbuf = render_gbuffer(_dev(static), _dev(frame), _dev(arena), cam, width, height)
    valid = np.asarray(gbuf["valid"])
    assert valid.any(), "test scene should cover some pixels"
    n_dec = np.asarray(signed_oct_decode(gbuf["normal_metallic"][..., :3]))
    n_true = np.asarray(gbuf["surface"]["normal_ws"])
    dots = np.sum(n_dec[valid] * n_true[valid], axis=-1)
    assert dots.min() > 0.999
    # reverse-z: valid depths in (0, 1], nearer surfaces have larger depth
    d = np.asarray(gbuf["depth"])[valid]
    assert (d > 0).all() and (d <= 1.0 + 1e-6).all()


def test_deferred_matches_forward_still_frame():
    """Deferred (clustered) and forward shading agree on a still frame."""
    from prosper_tpu.render.deferred import render_deferred
    from prosper_tpu.render.forward import render_forward
    from prosper_tpu.ops.tonemap import generated_lut

    static, frame, arena, cam_fn = make_test_scene()
    width = height = 64
    cam = {k: jnp.asarray(v) for k, v in cam_fn(width, height).items()}
    lut = jnp.asarray(generated_lut())
    img_d, _ = render_deferred(
        _dev(static), _dev(frame), _dev(arena), cam, lut, width, height
    )
    img_f = render_forward(
        _dev(static), _dev(frame), _dev(arena), cam, lut, width, height
    )
    # same lighting math; differences only from oct-encode quantization
    np.testing.assert_allclose(np.asarray(img_d), np.asarray(img_f), atol=5e-3)


def test_deferred_state_threads_hiz_across_frames():
    """The depth pyramid is preserve()d across frames
    (ForwardRenderer.hpp:142): frame 2's phase-1 cull tests against
    frame 1's HiZ and the image stays identical (static camera)."""
    from prosper_tpu.render.deferred import deferred_entry
    from prosper_tpu.ops.tonemap import generated_lut

    static, frame, arena, cam_fn = make_test_scene()
    width = height = 64
    cam = {k: jnp.asarray(v) for k, v in cam_fn(width, height).items()}
    lut = jnp.asarray(generated_lut())
    kw = dict(
        static=_dev(static), frame=_dev(frame), arena=_dev(arena), cam=cam,
        lut=lut, width=width, height=height, use_culling=True,
    )
    img1, state = deferred_entry(state=None, **kw)
    assert state["hiz"] is not None and len(state["hiz"]) >= 1
    img2, state2 = deferred_entry(state=state, **kw)
    np.testing.assert_allclose(
        np.asarray(img2), np.asarray(img1), atol=1e-6
    )
    assert state2["hiz"] is not None
