"""chip_smoke.py's argument handling and its refusal to run without a
GPU (the run itself needs the card)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_defaults_run_one_card_smoke():
    args = chip_smoke.parse_args([])
    assert not args.four_cards and not args.tracer_ab


def test_options():
    args = chip_smoke.parse_args(["--four-cards"])
    assert args.four_cards and not args.tracer_ab
    assert chip_smoke.parse_args(["--tracer-ab"]).tracer_ab


def test_unknown_option_is_an_error():
    with pytest.raises(SystemExit) as e:
        chip_smoke.parse_args(["--frames", "3"])
    assert e.value.code == 2


def test_modes_cover_the_four_render_modes_at_1080p():
    assert set(chip_smoke.MODES) == {"forward", "pt", "deferred", "restir"}
    assert (chip_smoke.WIDTH, chip_smoke.HEIGHT) == (1920, 1080)
    assert "--scatter-lights" in chip_smoke.MODES["restir"]
    assert set(chip_smoke.SHARDED_MODES) == {"pt", "restir", "deferred"}


def test_fails_without_gpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not a GPU" in proc.stderr
