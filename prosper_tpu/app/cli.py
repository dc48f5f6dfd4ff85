"""Headless CLI — the replacement of the reference's windowed App
(SURVEY.md §7: "ImGui app -> headless CLI").

CLI surface modeled on /root/reference/src/main.cpp:46-130 (positional
scene file + options, TOML config merge with CLI priority) plus the
Renderer mode toggles (Renderer.hpp:107-117) as --mode/--flags.

Usage:
  python -m prosper_tpu.app.cli render [SCENE.gltf] --mode forward \
      --width 256 --height 256 --out frame.png

Without SCENE the seeded in-repo scene is rendered (written to
generated/ on first use, prosper_tpu/testing.seeded_scene_path).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _load_toml_defaults(path: str | None) -> dict:
    if not path:
        return {}
    import tomllib

    with open(path, "rb") as f:
        return tomllib.load(f)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="prosper_tpu")
    sub = p.add_subparsers(dest="command", required=True)
    r = sub.add_parser("render", help="render frames of a glTF scene")
    r.add_argument(
        "scene", nargs="?", default=None,
        help="glTF scene (default: the seeded in-repo scene)",
    )
    r.add_argument(
        "--lut", default=None, metavar="PATH",
        help="Tony McMapface LUT (.dds) for the display transform "
        "(default: the generated x/(1+x) LUT, ops/tonemap.generated_lut)",
    )
    r.add_argument("--config", help="TOML config file (CLI flags win)")
    r.add_argument(
        "--mode",
        default="forward",
        choices=["forward", "pt", "deferred", "restir"],
    )
    r.add_argument("--width", type=int, default=1920)
    r.add_argument("--height", type=int, default=1080)
    r.add_argument("--frames", type=int, default=1)
    r.add_argument("--time", type=float, default=0.0, help="animation time (s)")
    r.add_argument("--animate", action="store_true", help="advance time per frame")
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--contrast", type=float, default=1.0)
    r.add_argument("--max-bounces", type=int, default=3)
    r.add_argument("--taa", action="store_true", help="TAA resolve (deferred mode)")
    r.add_argument("--ibl", action="store_true", help="IBL + procedural sky env")
    r.add_argument("--env-res", type=int, default=256,
                   help="procedural sky cubemap face resolution")
    r.add_argument("--culling", action="store_true", help="two-phase meshlet culling (deferred)")
    r.add_argument("--bloom", action="store_true", help="bloom (deferred mode)")
    r.add_argument(
        "--bloom-technique",
        default="multi_res",
        choices=["multi_res", "fft"],
        help="bloom technique (Bloom.hpp:56-70)",
    )
    r.add_argument("--dof", action="store_true", help="depth of field (deferred mode)")
    r.add_argument(
        "--autofocus",
        action="store_true",
        help="DoF focus from a frame-late center depth pick (App.cpp:607-631)",
    )
    r.add_argument(
        "--particles",
        action="store_true",
        help="toy particle system, drawn pre-TAA (Renderer.cpp:531-538)",
    )
    r.add_argument(
        "--draw-type",
        default="default",
        help="debug AOV (forward mode): primitive_id|meshlet_id|mesh_id|"
        "material_id|position|shading_normal|texcoord0|albedo|roughness|metallic",
    )
    r.add_argument(
        "--aniso-taps", type=int, default=1, metavar="N",
        help="anisotropic material filtering: N trilinear taps along the "
        "uv-space major footprint axis (reference samplers run "
        "maxAnisotropy=16, WorldData.cpp:693-714; 1 = trilinear)",
    )
    r.add_argument("--dump-debug", default=None, metavar="PATH",
                   help="TextureDebug analog: also dump the last frame's "
                   "linear HDR color as PATH(.npy) and a normalized PNG")
    r.add_argument("--out", default="out/frame.png")
    r.add_argument("--max-texture-dim", type=int, default=2048)
    r.add_argument("--orbit-camera", action="store_true",
                   help="orbit the camera around the scene per frame")
    r.add_argument("--scatter-lights", type=int, default=0, metavar="N",
                   help="scatter N random point emitters (many-light/ReSTIR testing)")
    r.add_argument("--streaming", action="store_true",
                   help="async asset streaming (deferred loading)")
    r.add_argument("--no-cache", action="store_true", help="bypass asset caches")
    r.add_argument(
        "--instance-grid", type=int, default=1, metavar="N",
        help="replicate the scene on an NxN ground grid (scale testing; "
        "clusters/draw instances/TLAS scale with it)",
    )
    r.add_argument("--fps-limit", type=float, default=0.0,
                   help="cap frame rate like the reference's spin limiter (0 = off)")
    r.add_argument(
        "--profile", action="store_true",
        help="per-pass timing report (turns off XLA's CUDA command buffers "
        "so each kernel shows in the trace)",
    )
    r.add_argument(
        "--profile-device",
        action="store_true",
        help="trace the last frame and print per-op DEVICE times (the "
        "GPU-timestamp-query analog; wall clock includes host dispatch)",
    )
    r.add_argument("--platform", default=None, help="force JAX platform (cpu/gpu)")
    r.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="shard the frame over an N-device jax.sharding.Mesh "
        "(pt/restir/deferred; pixel bands + collectives, "
        "render/distributed.py). 0 = single device. With --platform cpu "
        "an N-way virtual mesh is created for validation; keep frames "
        "small there (XLA's CPU collectives time out if slow bands "
        "arrive >40s apart)",
    )
    r.add_argument(
        "--watch",
        action="store_true",
        help="shader hot-reload analog (App::recompileShaders): after "
        "rendering, poll source mtimes and re-render on change — the XLA "
        "compile cache makes unchanged passes free to 'recompile'",
    )
    return p


def _source_mtimes(root: str) -> dict:
    """mtime snapshot of the package sources (the recursive res/shader
    scan analog, App.cpp:248-277)."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cpp")):
                p = os.path.join(dirpath, f)
                try:
                    out[p] = os.stat(p).st_mtime
                except OSError:
                    pass
    return out


def _draw_type_index(name: str) -> int:
    from ..render.debug import DRAW_TYPE_NAMES

    return DRAW_TYPE_NAMES.index(name.lower())


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    toml_cfg = _load_toml_defaults(getattr(args, "config", None))
    for k, v in toml_cfg.items():
        k = k.replace("-", "_")
        if hasattr(args, k):
            # CLI wins only when explicitly given; argparse defaults lose.
            # Simple policy: TOML overrides defaults, not explicit flags —
            # detecting explicitness cheaply via sys.argv scan.
            flag = "--" + k.replace("_", "-")
            if flag not in (sys.argv if argv is None else argv):
                setattr(args, k, v)

    if args.profile or args.profile_device:
        from ..utils.profiler import expose_device_ops

        expose_device_ops()
    import jax

    # float32 matrix products at full precision: on Hopper they would
    # otherwise run in TF32, which breaks watertight hits at t_min=1e-4
    jax.config.update("jax_default_matmul_precision", "highest")
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
        if args.platform == "cpu" and args.devices > 1:
            # virtual CPU mesh for --devices without a multi-device host
            # (same mechanism as tests/conftest.py); must precede backend
            # init
            jax.config.update("jax_num_cpu_devices", args.devices)

    import jax.numpy as jnp

    from ..io.image import write_png
    from ..ops.tonemap import generated_lut, load_tony_mc_mapface
    from ..scene.textures import build_texture_arena
    from ..scene.world import World
    from ..utils.logger import log_info

    from ..scene.caches import enable_compile_cache

    enable_compile_cache()

    if args.scene is None:
        from ..testing import seeded_scene_path

        args.scene = seeded_scene_path()
    t0 = time.time()
    world = World(
        args.scene, use_cache=not args.no_cache, streaming=args.streaming,
        instance_grid=args.instance_grid,
    )
    texture_jobs = []
    if args.streaming:
        # layout from headers; contents stream in after meshes
        from ..scene.textures import build_streaming_arena

        arena, texture_jobs = build_streaming_arena(
            world.doc,
            max_dim=args.max_texture_dim,
            scene_path=None if args.no_cache else args.scene,
        )
    else:
        arena = build_texture_arena(
            world.doc,
            max_dim=args.max_texture_dim,
            scene_path=None if args.no_cache else args.scene,
        )
    log_info("Scene ready in %.2fs", time.time() - t0)

    static = {
        k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict) else jnp.asarray(v))
        for k, v in world.static_scene_arrays().items()
    }
    arena_dev = {k: jnp.asarray(v) for k, v in arena.uniforms().items()}
    from ..ops.texture import pack_material_tables

    arena_dev["mat_f32"], arena_dev["mat_i32"] = pack_material_tables(
        world.static_scene_arrays()["materials"], arena_dev
    )
    lut = jnp.asarray(
        load_tony_mc_mapface(args.lut) if args.lut else generated_lut()
    )
    from ..ops import trace as trace_mod

    geom_cache = trace_mod.GeometryCache()
    # camera jitter rides with TAA like the reference (Renderer.cpp:329-340)
    cam_obj = world.make_camera((args.width, args.height), apply_jitter=args.taa)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)

    from ..render.frame import render_modes

    mesh = None
    if args.devices and args.devices > 1:
        import jax

        from ..render.distributed import (
            make_mesh,
            replicate_to_mesh,
            sharded_render_modes,
        )

        if len(jax.devices()) < args.devices:
            print(
                f"error: --devices {args.devices} but only "
                f"{len(jax.devices())} JAX devices visible",
                file=sys.stderr,
            )
            return 2
        mesh = make_mesh(args.devices)
        sharded = sharded_render_modes(mesh)
        if args.mode not in sharded:
            print(
                f"error: --devices does not support mode {args.mode!r} "
                f"(sharded modes: {sorted(sharded)})",
                file=sys.stderr,
            )
            return 2
        dropped = [
            f for f, on in (
                ("--taa", args.taa), ("--bloom", args.bloom),
                ("--dof", args.dof), ("--particles", args.particles),
                ("--culling", args.culling),
            ) if on
        ]
        if dropped:
            log_info(
                "sharded mode ignores post/culling flags: %s",
                " ".join(dropped),
            )
        # scene data is replicated once; per-frame uploads stay small
        static = replicate_to_mesh(static, mesh)
        arena_dev = replicate_to_mesh(arena_dev, mesh)
        render_fn = sharded[args.mode]
    else:
        render_fn = render_modes()[args.mode]

    ibl_data = None
    env = None
    if args.ibl:
        from ..ops.ibl import build_ibl, procedural_sky

        if args.env_res < 2:
            print(f"error: --env-res must be >= 2, got {args.env_res}", file=sys.stderr)
            return 2
        env = procedural_sky(args.env_res)
        ibl_data = build_ibl(env)
        ibl_data["env"] = env
        log_info("IBL generated")

    from ..utils.profiler import Profiler

    # sync_device stays False: device times come from the non-blocking
    # per-pass xplane report after the loop (utils/profiler.profile_passes)
    # instead of block_until_ready fences that would serialize the
    # two-frames-in-flight pipeline.
    profiler = Profiler(sync_device=False)

    if args.scatter_lights > 0:
        # many-light testing: scatter emitters in the scene bounds (the
        # reference's commented-out light scattering, WorldData.cpp:213)
        rng = np.random.default_rng(0)
        n = min(args.scatter_lights, 1024)
        lo = world.wc_aabb_min_obj.min(axis=0)
        hi = world.wc_aabb_max_obj.max(axis=0)
        world.lights.point_position[:n] = rng.uniform(lo, hi, (n, 3))
        world.lights.point_radiance[:n] = rng.uniform(0.05, 0.5, (n, 3))
        world.lights.point_radius[:n] = float(np.linalg.norm(hi - lo))
        world.lights.point_count = n
        log_info("scattered %d point lights", n)

    import numpy as _np

    base_eye = _np.array(cam_obj.transform.eye, _np.float32)
    base_target = _np.array(cam_obj.transform.target, _np.float32)

    state = None
    img = None
    from ..render.readback import TextureReadback

    focus_readback = TextureReadback()
    # two frames in flight (src/utils/Utils.hpp:15 MAX_FRAMES_IN_FLIGHT):
    # JAX async dispatch stands in for the command-buffer queue — frame
    # f+1's host prep (animation, frame_arrays, BVH build) overlaps frame
    # f's device execution; we only block when the pipeline is full.
    from collections import deque

    inflight = deque()

    def _drain(limit):
        while len(inflight) >= limit:
            f0, img0, t00 = inflight.popleft()
            img0.block_until_ready()
            log_info("frame %d: %.1f ms", f0, (time.time() - t00) * 1e3)

    for f in range(args.frames):
        profiler.start_frame()
        if args.orbit_camera and f > 0:
            from ..scene.camera import CameraTransform

            ang = 2.0 * _np.pi * f / max(args.frames, 1)
            rel = base_eye - base_target
            rot = _np.array(
                [
                    [_np.cos(ang), 0, _np.sin(ang)],
                    [0, 1, 0],
                    [-_np.sin(ang), 0, _np.cos(ang)],
                ],
                _np.float32,
            )
            cam_obj.look_at(
                CameraTransform(
                    eye=base_target + rot @ rel,
                    target=base_target,
                    up=_np.array([0, 1, 0], _np.float32),
                )
            )
        if args.streaming:
            if f == 0:
                world.start_streaming(texture_jobs)
            if world.poll_streaming():
                # texture adoption: in-place arena writes over the
                # neutral regions (pollTextureWorker analog)
                from ..scene.textures import arena_write

                for tex in world.take_adopted_textures():
                    arena_dev["data"] = arena_write(
                        arena_dev["data"], tex.chunk, tex.offset
                    )
                if world.streaming_dirty:
                    # mesh adoption: re-stream the touched arenas to HBM
                    static = {
                        k: (
                            {kk: jnp.asarray(vv) for kk, vv in v.items()}
                            if isinstance(v, dict)
                            else jnp.asarray(v)
                        )
                        for k, v in world.static_scene_arrays().items()
                    }
                    world.streaming_dirty = False
                    geom_cache = trace_mod.GeometryCache()  # new arenas
        if args.autofocus:
            # non-stalling depth-pick: poll the readback queued ~a frame
            # ago (TextureReadback / App.cpp:607-631 protocol); the D2H
            # copy overlapped the intervening device work
            d = focus_readback.poll()
            if d is not None:
                from ..render.readback import focus_from_depth

                cam_obj.parameters.focus_distance = focus_from_depth(
                    float(d), cam_obj.uniforms()
                )
        t_anim = args.time + (f / 60.0 if args.animate else 0.0)
        frame = world.frame_arrays(t_anim)
        frame_dev = {
            k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict) else jnp.asarray(v))
            for k, v in frame.items()
            if k not in ("scene_camera", "bvh_depth")
        }
        if mesh is None:
            # world-space geometry slabs recomputed only on transform
            # change (static BLAS + per-frame TLAS pacing,
            # World.cpp:749-802); the sharded path preps per shard
            frame_dev["geom"] = geom_cache.get(
                static, frame["transforms"], frame["normal_transforms"]
            )
        cam = {k: jnp.asarray(v) for k, v in cam_obj.uniforms().items()}
        t0 = time.time()
        img, state = render_fn(
            static=static,
            frame=frame_dev,
            arena=arena_dev,
            cam=cam,
            lut=lut,
            width=args.width,
            height=args.height,
            exposure=args.exposure,
            contrast=args.contrast,
            max_bounces=args.max_bounces,
            frame_index=f,
            state=state,
            use_taa=args.taa,
            use_bloom=args.bloom,
            use_dof=args.dof,
            use_culling=args.culling,
            use_particles=args.particles,
            bloom_technique=args.bloom_technique,
            # transparent pass only when the scene has blend materials
            # (recordTransparent draws the blend alpha-mode draw list)
            use_transparent=bool((world.materials.alpha_mode == 2).any()),
            ibl_data=ibl_data,
            env=env,
            draw_type=_draw_type_index(args.draw_type),
            aniso_taps=args.aniso_taps,
            # stochastic-alpha any-hit only when the scene has non-opaque
            # materials (scene.rahit parity)
            alpha_rounds=2 if bool((world.materials.alpha_mode != 0).any()) else 0,
        )
        inflight.append((f, img, t0))
        if args.autofocus and isinstance(state, dict) and state.get("depth") is not None:
            # queue this frame's center-depth pick; polled next frame
            focus_readback.queue(state["depth"], (0.5, 0.5))
        _drain(2)
        cam_obj.end_frame()
        report = profiler.end_frame()
        if args.profile:
            print(report.table())
        if args.fps_limit > 0:
            # spin-to-deadline frame cap (App.cpp capFramerate analog)
            target = 1.0 / args.fps_limit
            while (time.time() - t0) < target:
                pass
    _drain(1)

    if args.profile or args.profile_device:
        last_f = max(args.frames - 1, 0)

        def _rerun_frame():
            return render_fn(
                static=static, frame=frame_dev, arena=arena_dev, cam=cam,
                lut=lut, width=args.width, height=args.height,
                exposure=args.exposure, contrast=args.contrast,
                max_bounces=args.max_bounces, frame_index=last_f,
                state=state, use_taa=args.taa, use_bloom=args.bloom,
                use_dof=args.dof, use_culling=args.culling,
                use_particles=args.particles,
                bloom_technique=args.bloom_technique,
                use_transparent=bool((world.materials.alpha_mode == 2).any()),
                ibl_data=ibl_data, env=env,
                draw_type=_draw_type_index(args.draw_type),
                aniso_taps=args.aniso_taps,
                alpha_rounds=2
                if bool((world.materials.alpha_mode != 0).any())
                else 0,
            )[0]

    if args.profile:
        # per-PASS device table (Profiler.hpp:19-327 per-pass GPU query
        # analog): named-scope HLO metadata joined with one non-blocking
        # xplane trace of a warm steady-state frame
        from ..utils.profiler import profile_passes

        rows = profile_passes(_rerun_frame, lambda x: float(x.mean()))
        print(f"{'pass':<28}{'device ms':>12}")
        for name, ms in rows:
            print(f"{name:<28}{ms:>12.2f}")
        print(f"{'frame total':<28}{sum(ms for _, ms in rows):>12.2f}")

    if args.profile_device:
        from ..utils.profiler import profile_device_ops

        ops = profile_device_ops(
            lambda: render_fn(
                static=static, frame=frame_dev, arena=arena_dev, cam=cam,
                lut=lut, width=args.width, height=args.height,
                exposure=args.exposure, contrast=args.contrast,
                max_bounces=args.max_bounces, frame_index=last_f,
                state=state, use_taa=args.taa, use_bloom=args.bloom,
                use_dof=args.dof, use_culling=args.culling,
                use_particles=args.particles,
                bloom_technique=args.bloom_technique,
                use_transparent=bool((world.materials.alpha_mode == 2).any()),
                ibl_data=ibl_data, env=env,
                draw_type=_draw_type_index(args.draw_type),
                alpha_rounds=2
                if bool((world.materials.alpha_mode != 0).any())
                else 0,
            )[0],
            lambda x: float(x.mean()),
        )
        print(f"{'device op':<70}{'ms':>10}")
        for name, ms in ops:
            print(f"{name[:70]:<70}{ms:>10.2f}")

    write_png(args.out, np.asarray(img))
    log_info("wrote %s", args.out)
    if args.dump_debug:
        from ..render.debug import dump_texture
        from ..render.frame import frame_hdr

        dump_texture(frame_hdr(state), args.dump_debug)
        log_info("dumped %s(.npy)", args.dump_debug)

    if args.watch:
        # hot-reload dev loop: wait for a source edit, then re-exec this
        # render (compile cache keeps unchanged passes warm) — the
        # polling recompile of App::recompileShaders (App.cpp:235-307)
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        snap = _source_mtimes(pkg_root)
        log_info("watching %s for changes...", pkg_root)
        while _source_mtimes(pkg_root) == snap:
            time.sleep(0.5)
        log_info("source changed; reloading")
        os.execv(sys.executable, [sys.executable, "-m", "prosper_tpu.app.cli"]
                 + (sys.argv[1:] if argv is None else list(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
