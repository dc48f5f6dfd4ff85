"""Golden-image regression tests (BASELINE config 1 harness shape).

Each mode's GOLDEN_RES^2 frame of the small seeded scene
(prosper_tpu/parity.golden_frame, generated display LUT) is pinned
against a SELF-golden rendered on the CPU and committed to the repo —
any change to loader, traversal, shading, or tonemap that shifts the
image past tolerance fails here. The same goldens are the CPU side of
the GPU frame parity check (chip_smoke.py).
Regenerate with: python -m tests.test_goldens regen
"""

import os

import numpy as np

from prosper_tpu.parity import GOLDEN_MODES, GOLDEN_RES, golden_frame

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def golden_path(mode: str) -> str:
    return os.path.join(GOLDEN_DIR, f"{mode}_seeded_{GOLDEN_RES}.npy")


def _check_golden(mode):
    img = golden_frame(mode)
    golden = np.load(golden_path(mode)).astype(np.float32)
    rmse = float(np.sqrt(np.mean((img - golden) ** 2)))
    assert rmse < 1e-3, f"{mode} RMSE vs golden {rmse}"


def test_forward_seeded_golden():
    _check_golden("forward")


def test_pt_seeded_golden():
    """1-spp 2-bounce PT sample with a fixed seed (BASELINE config 2
    harness shape at self-golden scale)."""
    _check_golden("pt")


def test_deferred_post_seeded_golden():
    """Deferred + bloom + DoF chain (configs 3/5 harness shape)."""
    _check_golden("deferred")


def test_restir_seeded_golden():
    """ReSTIR DI frame, frame_index 0 (config 4 harness shape)."""
    _check_golden("restir")


if __name__ == "__main__":
    import sys

    # match conftest.py exactly: goldens are pinned against the test
    # environment's numerics (device count/x64 config change XLA fusion
    # rounding at the ~1e-3 level)
    import jax

    from prosper_tpu.scene.caches import compile_cache_dir

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", False)
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        for mode in GOLDEN_MODES:
            np.save(golden_path(mode), golden_frame(mode).astype(np.float16))
            print(f"{mode} golden regenerated")
