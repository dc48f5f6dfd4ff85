#!/usr/bin/env python
"""Headline benchmark: PT Mrays/s, deferred and ReSTIR ms/frame at 1080p
on the seeded scene (prosper_tpu/testing.seeded_scene_path).

A parent orchestrator that imports no JAX runs each stage — {pt,
deferred, restir} — in its own subprocess, one at a time (so one process
holds the device), with a watchdog in the parent: a stage that hangs or
crashes is killed, retried once, and recorded as an error without
erasing the other stages' numbers. The parent prints cumulative JSON
snapshot lines, one after each completed stage, so the LAST line on
stdout is always the best-available merged result:

  {"metric": "pt_mrays_per_s", "value": N, "unit": "Mrays/s",
   "vs_baseline": N, "deferred_ms": N, "restir_ms": N,
   "backend": "gpu", "errors": {...}}

and exits non-zero when any stage failed. Children are invoked as
`bench.py --stage NAME`; each prints progress to stderr and ONE
stage-result JSON line to stdout, and runs its own watchdog slightly
under the parent's bound so a hang usually leaves a labeled error.

Budget: the north star is a 1080p frame at 30 FPS. The PT stage counts
the rays it actually traces per frame (primary + shadow + bounce), so
30 FPS corresponds to 30 x rays_per_frame; vs_baseline = measured Mrays/s
over that, and >= 1.0 means the target is met.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import traceback

WIDTH, HEIGHT = 1920, 1080
MAX_BOUNCES = 3
WARMUP_FRAMES = 2
BENCH_FRAMES = 8
TARGET_FPS = 30.0

# Stage table: (name, child timeout_s, parent timeout_s). Parent bound
# is child bound + grace so the child's own watchdog usually fires
# first and leaves a labeled error on stdout; both leave headroom for a
# cold compile.
STAGES = (
    ("pt", 600, 630),
    ("deferred", 540, 570),
    ("restir", 540, 570),
)
RETRY_PAUSE_S = 5

# Harness-test hooks (tests/test_bench_harness.py simulates a hung stage
# without a device): global timeout overrides, retry-pause override,
# canned child results, and a child that sleeps forever. These exist so
# the recover-and-retry machinery itself is testable; they are not
# renderer configuration (that lives in the CLI/TOML layer).
_ENV_CHILD_TIMEOUT = "BENCH_CHILD_TIMEOUT_S"
_ENV_PARENT_TIMEOUT = "BENCH_PARENT_TIMEOUT_S"
_ENV_RETRY_PAUSE = "BENCH_RETRY_PAUSE_S"
_ENV_FAKE_RESULT = "BENCH_FAKE_RESULT"
_ENV_SIMULATE_WEDGE = "BENCH_SIMULATE_WEDGE"  # "stage" or "stage:attempt"


def _stage_plan():
    ct = os.environ.get(_ENV_CHILD_TIMEOUT)
    pt_ = os.environ.get(_ENV_PARENT_TIMEOUT)
    for name, c, p in STAGES:
        yield name, (float(ct) if ct else c), (float(pt_) if pt_ else p)


# --------------------------------------------------------------------------
# Parent: orchestrate stage subprocesses, merge, snapshot cumulatively.

RESULT = {
    "metric": "pt_mrays_per_s",
    "value": None,
    "unit": "Mrays/s",
    "vs_baseline": None,
    "deferred_ms": None,
    "restir_ms": None,
    "backend": None,
    "errors": {},
}


def snapshot():
    print(json.dumps(RESULT), flush=True)


def _last_json_line(text: str):
    """Last stdout line that parses as a JSON object with a "stage" key."""
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and "stage" in obj:
            return obj
    return None


def _run_stage_child(name: str, parent_timeout_s: float, extra_env=None, attempt=1):
    """One attempt: spawn `bench.py --stage name`, bound it, parse."""
    env = dict(os.environ)
    if extra_env:
        env.update(extra_env)
    env["BENCH_ATTEMPT"] = str(attempt)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--stage", name],
        stdout=subprocess.PIPE,
        stderr=sys.stderr,
        text=True,
        env=env,
    )
    try:
        out, _ = proc.communicate(timeout=parent_timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        obj = _last_json_line(out or "")
        return None, (
            f"parent watchdog: stage exceeded {parent_timeout_s}s — stage "
            f"wedged (child killed)"
            + (f"; child partial: {obj.get('error')}" if obj and obj.get("error") else "")
        )
    obj = _last_json_line(out or "")
    if obj is None:
        return None, f"child rc={proc.returncode}, no parseable stage JSON"
    if obj.get("error"):
        return None, f"child rc={proc.returncode}: {obj['error']}"
    return obj, None


def run_stage(name: str, child_timeout_s: float, parent_timeout_s: float):
    """Run a stage with ONE retry on any failure (hang, crash, garbage).

    Returns the stage-result dict or records RESULT["errors"][name]."""
    extra_env = {"BENCH_STAGE_TIMEOUT_S": str(child_timeout_s)}
    obj, err = _run_stage_child(name, parent_timeout_s, extra_env, attempt=1)
    if obj is not None:
        return obj
    pause = float(os.environ.get(_ENV_RETRY_PAUSE, RETRY_PAUSE_S))
    print(
        f"[bench] stage {name} attempt 1 failed ({err}); retrying in "
        f"{pause}s",
        file=sys.stderr,
        flush=True,
    )
    RESULT["errors"][f"{name}_attempt1"] = err
    snapshot()
    time.sleep(pause)
    obj, err2 = _run_stage_child(name, parent_timeout_s, extra_env, attempt=2)
    if obj is not None:
        # recovered: the attempt-1 record stays for legibility, but the
        # stage itself succeeded.
        return obj
    RESULT["errors"][name] = err2
    return None


def merge(name: str, obj: dict):
    if obj is None:
        return
    if obj.get("backend") and RESULT["backend"] is None:
        RESULT["backend"] = obj["backend"]
    if name == "pt":
        RESULT["value"] = obj.get("value")
        RESULT["vs_baseline"] = obj.get("vs_baseline")
        for k in ("rays_per_frame", "baseline_mrays"):
            if obj.get(k) is not None:
                RESULT[k] = obj[k]
    elif name in ("deferred", "restir"):
        RESULT[f"{name}_ms"] = obj.get("ms")


def parent_main() -> int:
    snapshot()  # guarantee at least one parseable line exists
    failed = []
    for name, child_t, parent_t in _stage_plan():
        obj = run_stage(name, child_t, parent_t)
        if obj is None:
            failed.append(name)
        merge(name, obj)
        snapshot()
    return 1 if failed else 0


# --------------------------------------------------------------------------
# Child: run ONE stage under an in-process watchdog, print stage JSON.

_SNAP_LOCK = threading.Lock()  # watchdog vs main-thread print race


def _child_emit(obj: dict):
    with _SNAP_LOCK:
        print(json.dumps(obj), flush=True)


def _child_watchdog(stage_name: str, timeout_s: float):
    _child_emit(
        {
            "stage": stage_name,
            "error": (
                f"watchdog: stage exceeded {timeout_s}s — stage wedged "
                f"(started but never completed)"
            ),
        }
    )
    # Distinct nonzero code: a hung run must not look like a pass to
    # rc-gating callers. Parent parses stdout regardless.
    os._exit(3)


def _setup_scene(jnp, with_lights: bool):
    from prosper_tpu.ops.texture import pack_material_tables
    from prosper_tpu.scene.textures import build_texture_arena
    from prosper_tpu.scene.world import World
    from prosper_tpu.testing import seeded_scene_path

    world = World(seeded_scene_path())
    if with_lights:
        import numpy as np

        rng = np.random.default_rng(0)
        lo = world.wc_aabb_min_obj.min(axis=0)
        hi = world.wc_aabb_max_obj.max(axis=0)
        n_lights = 1024
        world.lights.point_position[:n_lights] = rng.uniform(lo, hi, (n_lights, 3))
        world.lights.point_radiance[:n_lights] = rng.uniform(0.05, 0.5, (n_lights, 3))
        world.lights.point_radius[:n_lights] = float(np.linalg.norm(hi - lo))
        world.lights.point_count = n_lights
    arena = build_texture_arena(world.doc, max_dim=2048)
    static = {
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in world.static_scene_arrays().items()
    }
    arena_dev = {k: jnp.asarray(v) for k, v in arena.uniforms().items()}
    arena_dev["mat_f32"], arena_dev["mat_i32"] = pack_material_tables(
        world.static_scene_arrays()["materials"], arena_dev
    )
    frame = world.frame_arrays(0.0)
    frame_dev = {
        k: (
            {kk: jnp.asarray(vv) for kk, vv in v.items()}
            if isinstance(v, dict)
            else jnp.asarray(v)
        )
        for k, v in frame.items()
        if k not in ("scene_camera", "bvh_depth")
    }
    cam_obj = world.make_camera((WIDTH, HEIGHT))
    cam = {k: jnp.asarray(v) for k, v in cam_obj.uniforms().items()}
    from prosper_tpu.ops import trace as _trace

    frame_dev["geom"] = _trace.GeometryCache().get(
        static, frame["transforms"], frame["normal_transforms"]
    )
    return world, static, arena_dev, frame_dev, cam


def budget_mrays(rays_per_frame: int) -> float:
    """Mrays/s needed for TARGET_FPS at the live per-frame ray count."""
    return TARGET_FPS * rays_per_frame / 1e6


def stage_pt(jax, jnp) -> dict:
    from prosper_tpu.render.pt import pt_render_sample

    world, static, arena_dev, frame_dev, cam = _setup_scene(jnp, with_lights=False)

    def run(i):
        return pt_render_sample(
            static, frame_dev, arena_dev, cam, WIDTH, HEIGHT, i,
            max_bounces=MAX_BOUNCES, return_stats=True,
        )

    for i in range(WARMUP_FRAMES):
        color, n_rays = run(i)
        float(color.mean())

    # Steady-state throughput with two frames in flight, exactly like
    # the CLI frame loop (MAX_FRAMES_IN_FLIGHT=2, src/utils/Utils.hpp:15):
    # frame i+1 is dispatched before blocking on frame i. The forcing
    # reduction is enqueued with ITS OWN frame so blocking on it waits
    # only through frame i's tail. The median inter-frame completion
    # interval is robust to host hiccups.
    frames = []
    marks = [time.perf_counter()]
    prev = None
    for i in range(BENCH_FRAMES):
        color, n_rays = run(WARMUP_FRAMES + i)
        mean = color.mean()
        frames.append(n_rays)
        if prev is not None:
            float(prev)
            marks.append(time.perf_counter())
        prev = mean
    float(prev)
    marks.append(time.perf_counter())

    ray_counts = [int(n) for n in frames]
    per_frame = ray_counts[0]
    baseline = budget_mrays(per_frame)
    intervals = sorted(
        (marks[k + 1] - marks[k], ray_counts[k]) for k in range(len(ray_counts))
    )
    mid = len(intervals) // 2
    mrays = (
        intervals[mid - 1][1] / intervals[mid - 1][0]
        + intervals[mid][1] / intervals[mid][0]
    ) / 2.0 / 1e6
    return {
        "value": round(mrays, 2),
        "vs_baseline": round(mrays / baseline, 3),
        "rays_per_frame": per_frame,
        "baseline_mrays": round(baseline, 2),
    }


def stage_mode(jax, jnp, mode: str) -> dict:
    import numpy as np

    from prosper_tpu.ops.tonemap import generated_lut
    from prosper_tpu.render.frame import render_modes

    world, static_l, arena_dev, frame_dev, cam = _setup_scene(jnp, with_lights=True)
    lut = jnp.asarray(generated_lut())
    render = render_modes()[mode]
    state = None

    def run_mode(i, state):
        img, state = render(
            static=static_l, frame=frame_dev, arena=arena_dev, cam=cam,
            lut=lut, width=WIDTH, height=HEIGHT, frame_index=i,
            state=state, max_bounces=MAX_BOUNCES,
        )
        return img, state

    for i in range(2):  # warmup/compile
        img, state = run_mode(i, state)
        float(img.mean())
    # Two frames in flight like the CLI loop (and the PT stage): per-
    # frame forcing means enqueued with their own frame, median inter-
    # completion interval as the frame time.
    times = []
    prev = None
    t_prev = time.perf_counter()
    for i in range(7):
        img, state = run_mode(2 + i, state)
        mean = img.mean()
        if prev is not None:
            float(prev)
            t_now = time.perf_counter()
            times.append(t_now - t_prev)
            t_prev = t_now
        prev = mean
    float(prev)
    times.append(time.perf_counter() - t_prev)
    times.sort()
    return {"ms": round(times[len(times) // 2] * 1e3, 1)}


def child_main(stage_name: str) -> int:
    timeout_s = float(os.environ.get("BENCH_STAGE_TIMEOUT_S", "600"))
    dog = threading.Timer(timeout_s, _child_watchdog, (stage_name, timeout_s))
    dog.daemon = True
    dog.start()
    # Harness-test hooks: simulate a hung stage (sleep forever, under the
    # watchdog, exactly where a real stage would block) and canned
    # results so the parent machinery is testable without a device.
    wedge = os.environ.get(_ENV_SIMULATE_WEDGE, "")
    if wedge:
        target, _, att = wedge.partition(":")
        if target == stage_name and (not att or att == os.environ.get("BENCH_ATTEMPT", "1")):
            time.sleep(10**6)
    if os.environ.get(_ENV_FAKE_RESULT):
        canned = {
            "pt": {"value": 1.0, "vs_baseline": 0.017, "rays_per_frame": 2_000_000,
                   "baseline_mrays": 60.0},
            "deferred": {"ms": 1.0},
            "restir": {"ms": 2.0},
        }[stage_name]
        canned.update({"stage": stage_name, "backend": "fake"})
        dog.cancel()
        _child_emit(canned)
        return 0
    try:
        import jax

        from prosper_tpu.scene.caches import enable_compile_cache

        # float32 matrix products at full precision (no TF32 on Hopper):
        # watertight hits at t_min = 1e-4 need it
        jax.config.update("jax_default_matmul_precision", "highest")
        enable_compile_cache()
        jax.devices()  # force backend init under the watchdog
        import jax.numpy as jnp

        if stage_name == "pt":
            out = stage_pt(jax, jnp)
        elif stage_name in ("deferred", "restir"):
            out = stage_mode(jax, jnp, stage_name)
        else:
            raise ValueError(f"unknown stage {stage_name}")
        out["stage"] = stage_name
        out["backend"] = jax.default_backend()
        dog.cancel()
        _child_emit(out)
        return 0
    except BaseException as e:  # noqa: BLE001 — record, don't crash silently
        dog.cancel()
        tb = traceback.format_exc(limit=3)
        _child_emit(
            {"stage": stage_name, "error": f"{type(e).__name__}: {e} | {tb[-400:]}"}
        )
        return 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", default=None, help="(internal) run one stage")
    args = ap.parse_args()
    if args.stage:
        return child_main(args.stage)
    return parent_main()


if __name__ == "__main__":
    sys.exit(main())
