"""CLI + TOML config parity (main.cpp parseCli: TOML merged under CLI)."""

import sys

from prosper_tpu.app import cli


def test_parser_defaults():
    args = cli.build_parser().parse_args(["render"])
    assert args.width == 1920 and args.height == 1080  # main.cpp:29
    assert args.mode == "forward"
    assert args.scene is None  # -> the seeded in-repo scene
    assert args.lut is None  # -> the generated display LUT


def test_toml_overrides_defaults(tmp_path, monkeypatch):
    cfg = tmp_path / "cfg.toml"
    cfg.write_text('width = 640\nheight = 360\nmode = "pt"\n')
    argv = ["render", "--config", str(cfg)]
    args = cli.build_parser().parse_args(argv)
    # emulate main()'s merge
    import tomllib

    with open(cfg, "rb") as f:
        toml_cfg = tomllib.load(f)
    for k, v in toml_cfg.items():
        k2 = k.replace("-", "_")
        flag = "--" + k2.replace("_", "-")
        if hasattr(args, k2) and flag not in argv:
            setattr(args, k2, v)
    assert args.width == 640 and args.height == 360 and args.mode == "pt"


def test_cli_wins_over_toml(tmp_path):
    cfg = tmp_path / "cfg.toml"
    cfg.write_text("width = 640\n")
    argv = ["render", "--config", str(cfg), "--width", "320"]
    args = cli.build_parser().parse_args(argv)
    import tomllib

    with open(cfg, "rb") as f:
        toml_cfg = tomllib.load(f)
    for k, v in toml_cfg.items():
        k2 = k.replace("-", "_")
        flag = "--" + k2.replace("_", "-")
        if hasattr(args, k2) and flag not in argv:
            setattr(args, k2, v)
    assert args.width == 320  # CLI wins (main.cpp:46-130 semantics)


def test_draw_type_index():
    assert cli._draw_type_index("default") == 0
    assert cli._draw_type_index("shading_normal") == 6
    assert cli._draw_type_index("metallic") == 10


def _write_tiny_gltf(path):
    """Minimal valid glTF: one quad (POSITION only, data-URI buffer) and
    one KHR point light. Exercises the loader's attribute-derivation
    fallbacks (smooth normals, generated tangents/uvs)."""
    import base64
    import json

    import numpy as np

    pos = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32
    )
    idx = np.array([0, 1, 2, 2, 1, 3], np.uint16)
    buf = pos.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0},
            {
                "extensions": {"KHR_lights_punctual": {"light": 0}},
                "translation": [0.5, 0.5, 1.0],
            },
        ],
        "extensions": {
            "KHR_lights_punctual": {
                "lights": [
                    {"type": "point", "color": [1, 1, 1], "intensity": 50.0}
                ]
            }
        },
        "extensionsUsed": ["KHR_lights_punctual"],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [
            {
                "bufferView": 0,
                "componentType": 5126,
                "count": 4,
                "type": "VEC3",
                "min": [0, 0, 0],
                "max": [1, 1, 0],
            },
            {"bufferView": 1, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos.tobytes())},
            {
                "buffer": 0,
                "byteOffset": len(pos.tobytes()),
                "byteLength": len(idx.tobytes()),
            },
        ],
        "buffers": [
            {
                "byteLength": len(buf),
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(buf).decode(),
            }
        ],
    }
    path.write_text(json.dumps(doc))


def test_cli_end_to_end_deferred_ibl(tmp_path):
    """Full main(): parse -> load glTF -> deferred+IBL render -> PNG."""
    import numpy as np
    from prosper_tpu.io.image import load_image_rgba8

    from prosper_tpu.app.cli import main

    scene = tmp_path / "tiny.gltf"
    _write_tiny_gltf(scene)
    out = tmp_path / "frame.png"
    rc = main(
        [
            "render",
            str(scene),
            "--mode", "deferred",
            "--ibl",
            "--env-res", "16",
            "--width", "64",
            "--height", "64",
            "--out", str(out),
            "--no-cache",
        ]
    )
    assert rc == 0
    img = load_image_rgba8(str(out))[..., :3]
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img.astype(np.float32)).all()
    assert img.std() > 0  # not a blank frame


def test_source_mtime_snapshot(tmp_path):
    """--watch's change detector (App::recompileShaders poll analog)."""
    import time

    from prosper_tpu.app.cli import _source_mtimes

    (tmp_path / "a.py").write_text("x = 1")
    (tmp_path / "b.cpp").write_text("int x;")
    (tmp_path / "ignored.txt").write_text("nope")
    s1 = _source_mtimes(str(tmp_path))
    assert len(s1) == 2
    assert _source_mtimes(str(tmp_path)) == s1
    time.sleep(0.01)
    (tmp_path / "a.py").write_text("x = 2")
    import os

    os.utime(tmp_path / "a.py")
    assert _source_mtimes(str(tmp_path)) != s1


def test_cli_devices_matches_single(tmp_path):
    """--devices 8 (pixel bands over the CPU mesh) must produce the
    single-device image."""
    import numpy as np
    from prosper_tpu.io.image import load_image_rgba8

    from prosper_tpu.app.cli import main

    scene = tmp_path / "tiny.gltf"
    _write_tiny_gltf(scene)
    out1 = tmp_path / "single.png"
    out8 = tmp_path / "mesh8.png"
    common = [
        "render", str(scene), "--mode", "pt", "--width", "64",
        "--height", "64", "--frames", "2", "--no-cache",
    ]
    assert main(common + ["--out", str(out1)]) == 0
    assert main(common + ["--out", str(out8), "--devices", "8"]) == 0
    a = load_image_rgba8(str(out1)).astype(np.int32)
    b = load_image_rgba8(str(out8)).astype(np.int32)
    # same math, different partitioning: allow 1 ulp of u8 rounding
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()


def test_cli_devices_deferred_matches_single(tmp_path):
    """--devices 8 deferred (band sharding, froxel-aligned 32-row bands)
    must produce the single-device image."""
    import numpy as np
    from prosper_tpu.io.image import load_image_rgba8

    from prosper_tpu.app.cli import main

    scene = tmp_path / "tiny.gltf"
    _write_tiny_gltf(scene)
    out1 = tmp_path / "single.png"
    out8 = tmp_path / "mesh8.png"
    common = [
        "render", str(scene), "--mode", "deferred", "--width", "64",
        "--height", "256", "--no-cache",
    ]
    assert main(common + ["--out", str(out1)]) == 0
    assert main(common + ["--out", str(out8), "--devices", "8"]) == 0
    a = load_image_rgba8(str(out1)).astype(np.int32)
    b = load_image_rgba8(str(out8)).astype(np.int32)
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()
