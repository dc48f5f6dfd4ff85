"""The seeded glTF scene (prosper_tpu/testing.py): deterministic from its
seed, loaded through the normal World path, FlightHelmet-class at full
size."""

import json
import os

import numpy as np
import pytest

from prosper_tpu import testing


def _files(d):
    return {
        f: open(os.path.join(d, f), "rb").read()
        for f in sorted(os.listdir(d))
    }


def test_same_seed_writes_same_bytes(tmp_path):
    a = testing.write_seeded_scene(str(tmp_path / "a"), "small", seed=3)
    b = testing.write_seeded_scene(str(tmp_path / "b"), "small", seed=3)
    fa, fb = _files(os.path.dirname(a)), _files(os.path.dirname(b))
    assert fa.keys() == fb.keys() and fa == fb
    assert "scene.gltf" in fa and "scene.bin" in fa
    assert sum(f.endswith(".png") for f in fa) == 18


def test_seed_changes_textures_not_geometry(tmp_path):
    a = os.path.dirname(testing.write_seeded_scene(str(tmp_path / "a"),
                                                   "small", seed=0))
    b = os.path.dirname(testing.write_seeded_scene(str(tmp_path / "b"),
                                                   "small", seed=1))
    fa, fb = _files(a), _files(b)
    assert fa["scene.bin"] == fb["scene.bin"]
    assert fa["metal_basecolor.png"] != fb["metal_basecolor.png"]


def test_small_scene_loads_through_world():
    from prosper_tpu.scene.world import World

    path = testing.seeded_scene_path("small")
    w = World(path, use_cache=False)
    assert len(w.doc.meshes) == 6
    assert len(w.doc.materials) == 6
    assert (w.materials.alpha_mode == 1).sum() == 1  # one mask
    assert (w.materials.alpha_mode == 2).sum() == 1  # one blend
    assert len(w.doc.animations) == 1
    assert int(w.wc_tri_count.sum()) == sum(
        len(m[2][3]) for m in testing.seeded_meshes("small")
    )
    f0, f1 = w.frame_arrays(0.0), w.frame_arrays(1.0)
    # the animated visor moves; everything else stays
    assert not np.allclose(f0["transforms"], f1["transforms"])
    assert w.lights.point_count == 2


def test_full_scene_is_flighthelmet_class():
    """>= 94,722 triangles in >= 766 clusters of 128 over >= 5 meshes
    (the clusters as World builds them), 2048^2 textures."""
    from prosper_tpu.scene.meshlets import build_clusters

    meshes = testing.seeded_meshes("full")
    assert len(meshes) >= 5
    n_tris = sum(len(m[2][3]) for m in meshes)
    assert n_tris >= 94_722
    n_clusters = sum(
        len(build_clusters(m[2][0], m[2][3].reshape(-1)).cluster_count)
        for m in meshes
    )
    assert n_clusters >= 766
    assert testing.SCENE_SIZES["full"][1] == 2048


def test_scene_path_reuses_and_regenerates(tmp_path, monkeypatch):
    root = str(tmp_path)
    p = testing.seeded_scene_path("small", root=root)
    mtime = os.path.getmtime(p)
    assert testing.seeded_scene_path("small", root=root) == p
    assert os.path.getmtime(p) == mtime  # reused
    monkeypatch.setattr(testing, "SCENE_GENERATOR", "a newer generator")
    testing.seeded_scene_path("small", root=root)
    with open(p) as f:
        assert json.load(f)["asset"]["generator"] == "a newer generator"


@pytest.mark.parametrize("size", ["small", "full"])
def test_materials_have_all_pbr_textures(size, tmp_path):
    """Every material carries base-colour, normal and metallic-roughness
    textures; the mask/blend materials carry their alpha modes."""
    path = testing.write_seeded_scene(str(tmp_path), "small")
    doc = json.load(open(path))
    for m in doc["materials"]:
        pbr = m["pbrMetallicRoughness"]
        assert "baseColorTexture" in pbr
        assert "metallicRoughnessTexture" in pbr
        assert "normalTexture" in m
    modes = [m.get("alphaMode", "OPAQUE") for m in doc["materials"]]
    assert modes.count("MASK") == 1 and modes.count("BLEND") == 1
    edge = testing.SCENE_SIZES[size][1]
    assert edge in (64, 2048)
