#!/usr/bin/env python
"""End-to-end smoke run of the renderer on one NVIDIA GPU.

    python chip_smoke.py                 # the smoke run (one card)
    python chip_smoke.py --tracer-ab     # + CUDA vs plain tracer timings
    python chip_smoke.py --four-cards    # only the 4-card sharded path

The smoke run, in one process:
1. prints the card (`nvidia-smi` name and power limit) and JAX's devices,
   and fails unless JAX computes on a GPU;
2. writes the full-size seeded scene (prosper_tpu/testing.py);
3. renders every mode at 1920x1080 through the CLI entry point
   (prosper_tpu.app.cli.main) and checks each dumped HDR frame is finite
   and not black;
4. parity: the CUDA tracer against the plain XLA tracer on the primary,
   bounce and ReSTIR shadow ray sets of the full scene at 1080p, and each
   mode's 256^2 golden frame rendered on the GPU with the plain tracer
   against the CPU golden (tests/goldens).

--four-cards renders PT, ReSTIR and deferred with pixels sharded over a
4-GPU mesh and compares each HDR frame with the same sharded frame on a
1-GPU mesh (per-pixel RNG streams are placement-invariant).

Per-phase seconds and per-mode ms/frame go to earlier lines, and the
frames and a JSON report to out/smoke/. Every phase runs even when an
earlier one failed; the last line is one JSON object,
{"ok": true, "device": {...}}, only when all of them passed, and any
failed phase exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "out", "smoke")  # frames, HDR dumps, report
WIDTH, HEIGHT = 1920, 1080

MODES = {
    "forward": ["--mode", "forward", "--frames", "4"],
    "pt": ["--mode", "pt", "--frames", "4", "--max-bounces", "3"],
    "deferred": ["--mode", "deferred", "--taa", "--bloom", "--dof", "--ibl",
                 "--culling", "--frames", "4"],
    "restir": ["--mode", "restir", "--scatter-lights", "1024", "--frames",
               "4"],
}
SHARDED_MODES = ("pt", "restir", "deferred")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="chip_smoke.py",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded path and its 1-GPU "
                    "comparison")
    ap.add_argument("--tracer-ab", action="store_true",
                    help="also time the CUDA tracer against the plain "
                    "tracer, alone and inside 1080p PT/ReSTIR frames")
    return ap.parse_args(argv)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


class FrameTimes(logging.Handler):
    """Collects the CLI's "frame %d: %.1f ms" log records."""

    def __init__(self):
        super().__init__()
        self.ms: list[float] = []

    def emit(self, record):
        if record.msg == "frame %d: %.1f ms":
            self.ms.append(float(record.args[1]))


def steady_ms(frame_ms: list[float]) -> float:
    """Median CLI frame time after the first two frames, which compile
    (the first frame and the first one with carried state)."""
    import statistics

    return statistics.median(frame_ms[2:] or frame_ms or [float("nan")])


@contextlib.contextmanager
def phase(name: str, report: dict):
    """Times one phase into report["phase_s"] and prints its outcome."""
    t0 = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    status = "FAILED"
    try:
        yield
        status = "ok"
    finally:
        dt = time.perf_counter() - t0
        report.setdefault("phase_s", {})[name] = round(dt, 2)
        print(f"[phase] {name}: {status} in {dt:.2f} s", flush=True)


def render_modes_via_cli(scene: str, report: dict) -> None:
    import numpy as np

    from prosper_tpu.app import cli
    from prosper_tpu.utils import logger  # noqa: F401 (sets up the logger)

    os.makedirs(OUT_DIR, exist_ok=True)
    for mode, flags in MODES.items():
        hdr_path = os.path.join(OUT_DIR, f"{mode}_hdr.png")
        times = FrameTimes()
        logging.getLogger("prosper_tpu").addHandler(times)
        try:
            with phase(f"render_{mode}", report):
                rc = cli.main([
                    "render", scene, *flags,
                    "--width", str(WIDTH), "--height", str(HEIGHT),
                    "--out", os.path.join(OUT_DIR, f"{mode}.png"),
                    "--dump-debug", hdr_path,
                ])
        finally:
            logging.getLogger("prosper_tpu").removeHandler(times)
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc} for {mode}")
        hdr = np.load(hdr_path + ".npy")
        finite = bool(np.isfinite(hdr).all())
        mean = float(np.nanmean(hdr))
        report.setdefault("modes", {})[mode] = {
            "frame_ms": times.ms,
            "steady_ms": steady_ms(times.ms),
            "hdr_mean": mean,
            "hdr_max": float(np.nanmax(hdr)),
            "finite": finite,
        }
        print(f"[mode] {mode}: {steady_ms(times.ms):.1f} ms/frame steady "
              f"(frames {times.ms}), HDR mean {mean:.4g}, finite {finite}",
              flush=True)
        if hdr.shape[:2] != (HEIGHT, WIDTH) or not finite or mean <= 1e-5:
            raise RuntimeError(f"{mode}: bad HDR frame {hdr.shape} "
                               f"finite={finite} mean={mean}")


def parity_phase(report: dict) -> None:
    import numpy as np

    from prosper_tpu import parity
    from prosper_tpu.ops import trace

    with phase("parity_tracer", report):
        scene = parity.load_scene("full", WIDTH, HEIGHT, max_texture_dim=64)
        rays = parity.ray_sets(scene)
        stats = parity.tracer_parity(scene, rays)
    report["tracer_parity"] = stats
    for name, s in stats.items():
        print(f"[parity] tracer {name}: {json.dumps(s)}", flush=True)

    golden_dir = os.path.join(ROOT, "tests", "goldens")
    frames = {}
    with phase("parity_frames", report):
        small = parity.load_scene("small")
        with trace.forced_tracer("plain"):
            for mode in parity.GOLDEN_MODES:
                ref = np.load(os.path.join(
                    golden_dir, f"{mode}_seeded_{parity.GOLDEN_RES}.npy"))
                frames[mode] = parity.frame_parity(
                    parity.golden_frame(mode, small), ref)
                print(f"[parity] {mode} GPU plain vs CPU golden: "
                      f"{json.dumps(frames[mode])}", flush=True)
    report["frame_parity"] = frames
    bad = [m for m, s in frames.items() if not parity.frame_parity_ok(s)]
    if not parity.tracer_parity_ok(stats) or bad:
        raise RuntimeError(
            f"parity outside tolerance: tracer ok="
            f"{parity.tracer_parity_ok(stats)} frames {bad} "
            f"(tolerances {parity.TRACER_TOL} {parity.FRAME_TOL})"
        )


def _time(fn, n: int = 3) -> float:
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def tracer_ab_phase(report: dict) -> None:
    """CUDA vs plain tracer: each ray set alone, then whole 1080p PT and
    ReSTIR frames with each tracer."""
    import jax

    from prosper_tpu import parity
    from prosper_tpu.ops import trace
    from prosper_tpu.render.pt import pt_render_sample
    from prosper_tpu.render.restir import render_restir

    ab = {}
    with phase("tracer_ab", report):
        scene = parity.load_scene("full", WIDTH, HEIGHT, scatter_lights=1024)
        rays = parity.ray_sets(scene)
        s, f = scene["static"], scene["frame"]

        def closest_fn(s, f, o, d, t_min, t_max):
            return trace.make_tracer(s, f).closest(o, d, t_min, t_max)

        def any_fn(s, f, o, d, t_min, t_max):
            return trace.make_tracer(s, f).any(o, d, t_min, t_max)

        for kind in ("cuda", "plain"):
            with trace.forced_tracer(kind):
                closest, anyhit = jax.jit(closest_fn), jax.jit(any_fn)
                for name, r in rays.items():
                    ab[f"{kind}_{name}_closest_ms"] = _time(
                        lambda: closest(s, f, *r))
                    ab[f"{kind}_{name}_any_ms"] = _time(
                        lambda: anyhit(s, f, *r))
                kw = dict(static_scene=s, frame=f, arena=scene["arena"],
                          cam=scene["cam"], width=WIDTH, height=HEIGHT)
                ab[f"{kind}_pt_frame_ms"] = _time(
                    lambda: pt_render_sample(frame_index=1, max_bounces=3,
                                             **kw), n=2)
                ab[f"{kind}_restir_frame_ms"] = _time(
                    lambda: render_restir(lut=scene["lut"], frame_index=1,
                                          **kw)[1], n=2)
                print(f"[tracer_ab] {kind}: " + json.dumps(
                    {k: round(v, 3) for k, v in ab.items()
                     if k.startswith(kind)}), flush=True)
    report["tracer_ab"] = ab


def four_card_phase(report: dict, size: str = "full", width: int = WIDTH,
                    height: int = HEIGHT) -> None:
    """Sharded PT, ReSTIR and deferred on a 4-device mesh against the same
    sharded frames on a 1-device mesh, on the seeded scene with 1024
    scattered point lights and textures cut to 256^2."""
    import numpy as np

    from prosper_tpu import parity
    from prosper_tpu.render.distributed import (
        make_mesh,
        replicate_to_mesh,
        sharded_render_modes,
    )
    from prosper_tpu.render.frame import frame_hdr

    out = {}
    with phase("four_cards_scene", report):
        # textures at 256^2: the comparison is of the sharding, and the
        # scene loads in a fraction of the time
        scene = parity.load_scene(size, width, height, scatter_lights=1024,
                                  max_texture_dim=256)
    for mode in SHARDED_MODES:
        with phase(f"four_cards_{mode}", report):
            hdr = {}
            for n in (4, 1):
                mesh = make_mesh(n)
                kw = dict(
                    static=replicate_to_mesh(scene["static"], mesh),
                    frame=replicate_to_mesh(scene["frame"], mesh),
                    arena=replicate_to_mesh(scene["arena"], mesh),
                    cam=scene["cam"], lut=scene["lut"], width=width,
                    height=height, frame_index=0, max_bounces=3,
                )
                fn = sharded_render_modes(mesh)[mode]
                fn(**kw)  # compile
                t0 = time.perf_counter()
                _img, state = fn(**kw)
                hdr[n] = np.asarray(frame_hdr(state))
                ms = (time.perf_counter() - t0) * 1e3
                out[f"{mode}_{n}dev_ms"] = round(ms, 1)
            err = np.abs(hdr[4] - hdr[1])
            diff = float(err.max())
            # share of pixels off by more than float rounding (a path can
            # diverge where one rounding flips a hit)
            off = float((err.max(-1) > 1e-4 * np.maximum(
                np.abs(hdr[1]).max(-1), 1.0)).mean())
            finite = bool(np.isfinite(hdr[4]).all())
            out[f"{mode}_max_abs_diff"] = diff
            out[f"{mode}_mean_abs_diff"] = float(err.mean())
            out[f"{mode}_pixels_off"] = off
            out[f"{mode}_hdr_mean"] = float(hdr[4].mean())
            print(f"[four_cards] {mode}: 4-dev {out[f'{mode}_4dev_ms']} ms, "
                  f"1-dev {out[f'{mode}_1dev_ms']} ms, max |HDR diff| "
                  f"{diff:.3g}, mean {err.mean():.3g}, pixels off {off:.3g}, "
                  f"HDR mean {hdr[4].mean():.4g}", flush=True)
            if not finite or hdr[4].mean() <= 1e-5:
                raise RuntimeError(f"{mode}: bad 4-device HDR frame")
            if off > 1e-3:
                raise RuntimeError(
                    f"{mode}: {off:.3%} of 4-device pixels differ")
    report["four_cards"] = out


def main(argv=None) -> int:
    args = parse_args(argv)
    import jax

    # float32 matrix products at full precision (no TF32): watertight hits
    jax.config.update("jax_default_matmul_precision", "highest")
    devices = jax.devices()
    print(f"[smoke] jax {jax.__version__} devices: {devices}", flush=True)
    if devices[0].platform != "gpu":
        print(f"error: JAX computes on {devices[0].platform!r}, not a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"error: needs {need} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 1

    from prosper_tpu.scene.caches import enable_compile_cache
    from prosper_tpu.testing import seeded_scene_path

    cache = enable_compile_cache()
    print(f"[smoke] compile cache: {cache}", flush=True)
    report: dict = {}
    t_start = time.perf_counter()
    with phase("scene", report):
        scene = seeded_scene_path("full")
    if args.four_cards:
        steps = [four_card_phase]
    else:
        steps = [lambda r: render_modes_via_cli(scene, r), parity_phase]
        if args.tracer_ab:
            steps.append(tracer_ab_phase)
    failed = []
    for step in steps:
        try:
            step(report)
        except Exception as e:  # noqa: BLE001 — report, run the rest, fail
            import traceback

            traceback.print_exc()
            print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
            failed.append(f"{type(e).__name__}: {e}")
    report["failed"] = failed
    report["total_s"] = round(time.perf_counter() - t_start, 2)
    os.makedirs(OUT_DIR, exist_ok=True)
    name = "four_cards.json" if args.four_cards else "report.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[smoke] phases (s): {json.dumps(report['phase_s'])}", flush=True)
    print(f"[smoke] total {report['total_s']} s", flush=True)
    if failed:
        print(f"error: {len(failed)} phase(s) failed", file=sys.stderr)
        return 1
    print(card, flush=True)
    d = devices[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
