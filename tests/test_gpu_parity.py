"""GPU parity wrappers around prosper_tpu/parity.py (chip_smoke.py runs
the same checks). Marked `gpu`: they skip without an NVIDIA GPU; run them
on one with `python -m pytest tests/ -m gpu`."""

import os

import numpy as np
import pytest

from prosper_tpu import parity

pytestmark = pytest.mark.gpu
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def test_cuda_tracer_matches_plain_tracer(gpu_backend):
    scene = parity.load_scene("small", 256, 256)
    stats = parity.tracer_parity(scene, parity.ray_sets(scene, n_lights=64))
    assert parity.tracer_parity_ok(stats), stats


@pytest.mark.parametrize("mode", parity.GOLDEN_MODES)
def test_gpu_plain_frame_matches_cpu_golden(gpu_backend, mode):
    from prosper_tpu.ops import trace

    ref = np.load(os.path.join(
        GOLDEN_DIR, f"{mode}_seeded_{parity.GOLDEN_RES}.npy"))
    with trace.forced_tracer("plain"):
        stats = parity.frame_parity(parity.golden_frame(mode), ref)
    assert parity.frame_parity_ok(stats), stats
