"""Deferred shading: G-buffer + clustered lights -> illumination.

Parity with /root/reference/res/shader/deferred_shading.comp: world-pos
reconstruction from depth, G-buffer decode, directional + clustered
point/spot evaluation, optional IBL. The froxel lists come from
ops/clustering.py (light_clustering.comp analog).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..mathx.packing import signed_oct_decode
from ..ops.clustering import build_light_clusters, eval_clustered_lights
from ..ops.tonemap import tone_map
from .shading import eval_directional_light


def shade_deferred(
    gbuf: dict,
    clusters: dict,
    lights: dict,
    cam: dict,
    width: int,
    height: int,
    ibl_data: dict | None = None,
    y_offset=0,
):
    """Clustered deferred shading over the flat row-major G-buffer.

    y_offset shades a horizontal band of a taller frame (multi-device
    pixel sharding): `height` rows starting at absolute row y_offset;
    froxel coordinates stay absolute."""
    px = jnp.tile(jnp.arange(width, dtype=jnp.int32), height)
    py = jnp.repeat(jnp.arange(height, dtype=jnp.int32), width) + y_offset

    # decode G-buffer exactly like loadFromGbuffer (visible_surface.glsl)
    albedo = gbuf["albedo_roughness"][..., :3]
    roughness = gbuf["albedo_roughness"][..., 3]
    normal = signed_oct_decode(gbuf["normal_metallic"][..., :3])
    metallic = gbuf["normal_metallic"][..., 3]

    pos = gbuf["position_ws"]
    inv_view = cam["eye"] - pos
    inv_view = inv_view / jnp.maximum(
        jnp.linalg.norm(inv_view, axis=-1, keepdims=True), 1e-20
    )

    surface = {
        "position_ws": pos,
        "normal_ws": normal,
        "inv_view_ray": inv_view,
        "albedo": albedo,
        "roughness": roughness,
        "metallic": metallic,
        "NoV": jnp.clip(jnp.sum(normal * inv_view, axis=-1), 0.0, 1.0),
    }

    color = eval_directional_light(surface, lights)
    color = color + eval_clustered_lights(
        surface,
        lights,
        clusters,
        px,
        py,
        gbuf["z_cam"],
        cam["near"],
        cam["far"],
    )
    if ibl_data is not None:
        from ..ops.ibl import eval_ibl

        color = color + eval_ibl(surface, ibl_data)
    return jnp.where(gbuf["valid"][..., None], color, 0.0)


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "use_taa", "use_bloom", "use_dof", "use_culling",
        "use_transparent", "use_particles", "bloom_technique",
        "alpha_rounds", "aniso_taps",
    ),
)
def render_deferred(
    static_scene: dict,
    frame: dict,
    arena: dict,
    cam: dict,
    lut: jnp.ndarray,
    width: int,
    height: int,
    exposure: float = 1.0,
    contrast: float = 1.0,
    use_taa: bool = False,
    use_bloom: bool = False,
    use_dof: bool = False,
    taa_history: jnp.ndarray | None = None,
    ibl_data: dict | None = None,
    use_culling: bool = False,
    prev_hiz: list | None = None,
    use_transparent: bool = False,
    use_particles: bool = False,
    bloom_technique: str = "multi_res",
    bloom_kernel: jnp.ndarray | None = None,
    particle_state: dict | None = None,
    alpha_rounds: int = 0,
    aniso_taps: int = 1,
    frame_index=0,
):
    """Deferred frame + optional post chain, in the reference's pass order
    (Renderer.cpp:485-584): skybox -> transparent -> bloom -> particles ->
    TAA -> DoF -> tone map.

    Returns (display image, aux dict: hdr, taa_history, particles,
    depth, hiz).
    """
    from .gbuffer import render_gbuffer

    # per-pass device attribution: named scopes become HLO op metadata
    # that utils/profiler.profile_passes joins with xplane timings — the
    # GPU-timestamp-scope analog inside one fused jit (Profiler.hpp:19)
    with jax.named_scope("gbuffer"):
        gbuf = render_gbuffer(
            static_scene, frame, arena, cam, width, height,
            use_culling=use_culling, prev_hiz=prev_hiz,
            lod_bias=-1.0 if use_taa else 0.0,
            alpha_rounds=alpha_rounds,
            aniso_taps=aniso_taps,
        )
    with jax.named_scope("light_clustering"):
        clusters = build_light_clusters(cam, frame["lights"], width, height)
    with jax.named_scope("shading"):
        color = shade_deferred(
            gbuf, clusters, frame["lights"], cam, width, height, ibl_data,
        )
    if ibl_data is not None and "env" in ibl_data:
        # skybox background (SkyboxRenderer analog): sample the env along
        # the view ray for miss pixels
        from ..ops.ibl import sample_cubemap
        from ..ops.rays import pinhole_rays

        with jax.named_scope("skybox"):
            ys, xs = jnp.meshgrid(
                (jnp.arange(height, dtype=jnp.float32) + 0.5) / height,
                (jnp.arange(width, dtype=jnp.float32) + 0.5) / width,
                indexing="ij",
            )
            _, vd = pinhole_rays(
                cam, jnp.stack([xs, ys], -1).reshape(height * width, 2)
            )
            sky = sample_cubemap(ibl_data["env"], vd)
            color = jnp.where(gbuf["valid"][..., None], color, sky)

    hdr = color.reshape(height, width, 3)

    if use_transparent:
        # ForwardRenderer::recordTransparent slot (Renderer.cpp:494-500)
        from .transparent import transparent_pass

        with jax.named_scope("transparent"):
            hdr = transparent_pass(
                static_scene, frame, arena, cam, hdr, gbuf["z_cam"],
                width, height, ibl_data,
            )

    if use_bloom:
        with jax.named_scope("bloom"):
            if bloom_technique == "fft":
                from ..ops.bloom import bloom_fft

                hdr = bloom_fft(hdr, kernel_image=bloom_kernel)
            else:
                from ..ops.bloom import bloom_multi_res

                hdr = bloom_multi_res(hdr)

    new_particles = None
    if use_particles:
        # Particles draw pre-TAA (Renderer.cpp:531-538): emitters were
        # spawned from lights at init (deferred_entry); one simulate step
        # then depth-tested dithered splats
        from ..ops.particles import render_particles, simulate

        # per-frame pcg stream (simulate.comp parity): the frame index
        # must advance or spawn/steer noise repeats identically
        with jax.named_scope("particles"):
            st = simulate(particle_state, 1.0 / 60.0, frame_index)
            depth_img = gbuf["depth"].reshape(height, width)
            hdr = render_particles(st, hdr, depth_img, cam)
        new_particles = st

    new_history = None
    if use_taa:
        from ..ops.taa import taa_resolve

        with jax.named_scope("taa"):
            velocity = gbuf["velocity"].reshape(height, width, 2)
            depth = gbuf["depth"].reshape(height, width)
            prev = hdr if taa_history is None else taa_history
            hdr = taa_resolve(hdr, prev, velocity, depth)
        new_history = hdr

    if use_dof:
        from ..ops.dof import depth_of_field

        with jax.named_scope("dof"):
            view_depth = jnp.maximum(
                -gbuf["z_cam"].reshape(height, width), 1e-3
            )
            hdr = depth_of_field(hdr, view_depth, cam)

    with jax.named_scope("tonemap"):
        img = tone_map(hdr, lut, exposure, contrast)
    aux = {
        "hdr": hdr,
        "taa_history": new_history,
        "particles": new_particles,
        "depth": gbuf["depth"].reshape(height, width),
        # preserve()d depth pyramid: next frame's phase-1 occlusion cull
        # tests against it (ForwardRenderer.hpp:142)
        "hiz": gbuf["hiz"],
    }
    return img, aux


def deferred_entry(
    *,
    static,
    frame,
    arena,
    cam,
    lut,
    width,
    height,
    exposure=1.0,
    contrast=1.0,
    state=None,
    use_taa=False,
    use_bloom=False,
    use_dof=False,
    use_transparent=False,
    use_particles=False,
    bloom_technique="multi_res",
    **kwargs,
):
    """CLI-facing deferred mode. `state` is a dict FrameState pytree
    (the preserve()d resources of the reference): taa_history, particles,
    bloom_kernel (FFT kernel image cached across frames, Bloom.hpp's
    releasePreserved), depth (for frame-late autofocus readback)."""
    state = dict(state) if state else {}

    particles = state.get("particles")
    if use_particles and particles is None:
        # Init pass: spawn emitters from the scene's point lights
        # (particles/init.comp analog), once like the reference
        import jax.numpy as _jnp

        from ..ops.particles import init_state, spawn_emitters

        lights = frame["lights"]
        n = int(lights["point_count"])
        if n == 0:
            pos = _jnp.zeros((1, 3), _jnp.float32)
            nrm = _jnp.array([[0.0, 1.0, 0.0]], _jnp.float32)
        else:
            pos = lights["point_position"][:n]
            nrm = _jnp.broadcast_to(
                _jnp.array([0.0, 1.0, 0.0], _jnp.float32), (n, 3)
            )
        particles = spawn_emitters(init_state(), pos, nrm)

    bloom_kernel = state.get("bloom_kernel")
    if use_bloom and bloom_technique == "fft" and bloom_kernel is None:
        from ..ops.bloom import generate_kernel

        # kernel dim matches bloom_fft's half-res FFT extent
        half = max((height + 1) // 2, (width + 1) // 2, 1)
        dim = 1 << (half - 1).bit_length()
        bloom_kernel = generate_kernel(dim)

    from ..utils.profiler import profiled_jit_call

    img, aux = profiled_jit_call(
        render_deferred,
        static,
        frame,
        arena,
        cam,
        lut,
        width,
        height,
        exposure,
        contrast,
        use_taa,
        use_bloom,
        use_dof,
        taa_history=state.get("taa_history"),
        ibl_data=kwargs.get("ibl_data"),
        use_culling=kwargs.get("use_culling", False),
        prev_hiz=state.get("hiz"),
        aniso_taps=kwargs.get("aniso_taps", 1),
        use_transparent=use_transparent,
        use_particles=use_particles,
        bloom_technique=bloom_technique,
        bloom_kernel=bloom_kernel,
        particle_state=particles,
        alpha_rounds=kwargs.get("alpha_rounds", 0),
        frame_index=kwargs.get("frame_index", 0),
    )
    new_state = {
        "hdr": aux["hdr"],
        "taa_history": aux["taa_history"],
        "particles": aux["particles"],
        "bloom_kernel": bloom_kernel,
        "depth": aux["depth"],
        "hiz": aux["hiz"],
    }
    return img, new_state
