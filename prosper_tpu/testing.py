"""Procedural scenes: tiny self-contained scene pytrees for unit tests,
the graft entry and sharding dry-runs (no glTF file needed), and the
seeded glTF scene the CLI, the bench and the golden tests load through
the normal World path."""

from __future__ import annotations

import os

import numpy as np

from .accel.bvh import build_bvh, pack_nodes
from .scene.camera import Camera, CameraParameters, CameraTransform
from .scene.lights import LightArrays, light_uniforms
from .scene.meshlets import CLUSTER_TRI_PAD


def make_test_scene(n_boxes: int = 4, seed: int = 0):
    """A grid of axis-aligned boxes (12 tris each), one cluster per box.

    Returns (static, frame, arena, cam_fn) where cam_fn(w, h) builds
    camera uniforms looking at the grid.
    """
    rng = np.random.default_rng(seed)
    pad = CLUSTER_TRI_PAD

    # unit cube triangles
    corners = np.array(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float32
    )
    faces = [
        (0, 1, 3, 2),  # x=0
        (4, 6, 7, 5),  # x=1
        (0, 4, 5, 1),  # y=0
        (2, 3, 7, 6),  # y=1
        (0, 2, 6, 4),  # z=0
        (1, 5, 7, 3),  # z=1
    ]
    tris = []
    for a, b, c, d in faces:
        tris.append((a, b, c))
        tris.append((a, c, d))
    tris = np.array(tris, np.int32)

    n_clusters = n_boxes
    S = n_clusters * pad
    wt_p0 = np.zeros((S, 3), np.float32)
    wt_p1 = np.zeros((S, 3), np.float32)
    wt_p2 = np.zeros((S, 3), np.float32)
    wt_aidx = np.zeros((S, 3), np.int32)
    wc_min = np.zeros((n_clusters, 3), np.float32)
    wc_max = np.zeros((n_clusters, 3), np.float32)

    a_normal = []
    a_tangent = []
    a_uv = []
    v_off = 0
    for b in range(n_boxes):
        origin = np.array([(b % 2) * 2.0 - 1.0, 0.0, (b // 2) * 2.0 - 1.0]) * 1.5
        verts = corners * 0.8 + origin
        base = b * pad
        wt_p0[base : base + 12] = verts[tris[:, 0]]
        wt_p1[base : base + 12] = verts[tris[:, 1]]
        wt_p2[base : base + 12] = verts[tris[:, 2]]
        wt_aidx[base : base + 12] = tris + v_off
        wc_min[b] = verts.min(axis=0)
        wc_max[b] = verts.max(axis=0)
        n = verts - verts.mean(axis=0)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        a_normal.append(n.astype(np.float32))
        t = np.cross(np.array([0.0, 1.0, 0.0]), n)
        t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-9)
        a_tangent.append(
            np.concatenate([t, np.ones((8, 1))], axis=1).astype(np.float32)
        )
        a_uv.append(rng.random((8, 2), dtype=np.float32))
        v_off += 8

    materials = {
        "base_color_factor": np.array(
            [[1, 1, 1, 1], [0.8, 0.4, 0.3, 1.0]], np.float32
        ),
        "metallic_factor": np.array([1.0, 0.1], np.float32),
        "roughness_factor": np.array([1.0, 0.7], np.float32),
        "alpha_cutoff": np.array([0.5, 0.5], np.float32),
        "alpha_mode": np.array([0, 0], np.int32),
        "base_color_tex": np.array([0, 0], np.int32),
        "metallic_roughness_tex": np.array([0, 0], np.int32),
        "normal_tex": np.array([0, 0], np.int32),
    }

    wc_center = (wc_min + wc_max) / 2
    wc_radius = np.linalg.norm(wc_max - wc_center, axis=1).astype(np.float32)
    static = {
        "wc_instance": np.zeros(n_clusters, np.int32),
        "wc_material": np.ones(n_clusters, np.int32),
        "wc_sphere_center": wc_center.astype(np.float32),
        "wc_sphere_radius": wc_radius,
        "wc_cone_axis": np.tile(np.array([[0, 0, 1.0]], np.float32), (n_clusters, 1)),
        "wc_cone_cutoff": np.ones(n_clusters, np.float32),  # never cone-cull
        "wc_tri_count": np.full(n_clusters, 12, np.int32),
        "wt_p0": wt_p0,
        "wt_p1": wt_p1,
        "wt_p2": wt_p2,
        "wt_aidx": wt_aidx,
        "wt_instance": np.zeros(S, np.int32),
        "wt_material": np.ones(S, np.int32),
        "a_packed": np.concatenate(
            [
                np.concatenate(
                    [n, t, uv, np.zeros((len(n), 3), np.float32)], axis=1
                )
                for n, t, uv in zip(a_normal, a_tangent, a_uv)
            ]
        ),
        "materials": materials,
    }

    bvh = build_bvh(wc_min, wc_max, max_leaf_size=1)
    lights = LightArrays()
    lights.point_radiance[0] = [30.0, 25.0, 20.0]
    lights.point_position[0] = [0.0, 3.0, 0.0]
    lights.point_radius[0] = 50.0
    lights.point_count = 1

    frame = {
        "wc_aabb_min_w": wc_min,
        "wc_aabb_max_w": wc_max,
        "transforms": np.eye(4, dtype=np.float32)[None, :3, :4],
        "normal_transforms": np.eye(3, dtype=np.float32)[None],
        "bvh_bounds": pack_nodes(bvh)[0],
        "bvh_meta": pack_nodes(bvh)[1],
        "lights": light_uniforms(lights),
    }

    # 1px white default texture arena (quad layout)
    arena = {
        "data": np.full((1, 4), 0xFFFFFFFF, np.uint32),
        "table": np.zeros((1, 13, 4), np.int32)
        + np.array([0, 1, 1, 0], np.int32)[None, None, :],
        "n_mips": np.ones(1, np.int32),
    }

    def cam_fn(width: int, height: int) -> dict:
        cam = Camera(
            (width, height),
            CameraParameters(),
            CameraTransform(
                eye=np.array([4.0, 3.5, 4.5], np.float32),
                target=np.array([0.0, 0.3, 0.0], np.float32),
                up=np.array([0.0, 1.0, 0.0], np.float32),
            ),
        )
        return cam.uniforms()

    return static, frame, arena, cam_fn


def make_stress_scene(n_clusters: int = 2048, seed: int = 0):
    """Sponza-class synthetic stress scene: n_clusters plates of 128
    triangles each (8x8 quad grids), scattered in a 3D grid — >=100k
    tris at 1024+ clusters, exercising the BVH traversal path at scale
    (BASELINE config 2 intent; the Sponza asset is absent from the
    mount). Returns (tris_dict, wc_min, wc_max, bvh_bounds, bvh_meta).
    """
    rng = np.random.default_rng(seed)
    pad = CLUSTER_TRI_PAD
    g = 8  # 8x8 quads -> 128 tris, a full cluster

    side = int(np.ceil(n_clusters ** (1.0 / 3.0)))
    S = n_clusters * pad
    p0 = np.zeros((S, 3), np.float32)
    p1 = np.zeros((S, 3), np.float32)
    p2 = np.zeros((S, 3), np.float32)
    wc_min = np.zeros((n_clusters, 3), np.float32)
    wc_max = np.zeros((n_clusters, 3), np.float32)

    # one plate's local grid (g*g quads = 2*g*g tris = 128)
    xs, ys = np.meshgrid(np.arange(g + 1), np.arange(g + 1), indexing="ij")
    verts = np.stack(
        [xs.ravel() / g, ys.ravel() / g, np.zeros((g + 1) * (g + 1))], 1
    ).astype(np.float32)
    quads = []
    for i in range(g):
        for j in range(g):
            a = i * (g + 1) + j
            b = a + 1
            c = a + (g + 1)
            d = c + 1
            quads += [(a, b, c), (b, d, c)]
    tris_local = np.array(quads, np.int32)

    for ci in range(n_clusters):
        cell = np.array(
            [ci % side, (ci // side) % side, ci // (side * side)], np.float32
        )
        origin = cell * 1.5 + rng.uniform(-0.2, 0.2, 3)
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        v = verts @ rot.T + origin
        base = ci * pad
        p0[base : base + 128] = v[tris_local[:, 0]]
        p1[base : base + 128] = v[tris_local[:, 1]]
        p2[base : base + 128] = v[tris_local[:, 2]]
        wc_min[ci] = v.min(axis=0)
        wc_max[ci] = v.max(axis=0)

    tris = {"v0": p0, "e1": p1 - p0, "e2": p2 - p0}
    bvh = build_bvh(wc_min, wc_max, max_leaf_size=1)
    bounds, meta = pack_nodes(bvh)
    return tris, wc_min, wc_max, bounds, meta


# ---------------------------------------------------------------------------
# Seeded glTF scene: the repository's own FlightHelmet-class asset
# ---------------------------------------------------------------------------

SCENE_GENERATOR = "prosper_tpu.testing seeded scene v2"
_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GENERATED_DIR = os.path.join(_REPO_ROOT, "generated")

# size -> (segment scale of every mesh, texture edge in texels). "full"
# matches the FlightHelmet bench scene: >= 94,722 triangles in >= 766
# clusters, 2048^2 material textures.
SCENE_SIZES = {"full": (1.0, 2048), "small": (0.125, 64)}


def _grid_indices(nu: int, nv: int) -> np.ndarray:
    """Two triangles per cell of an (nv+1) x (nu+1) vertex grid."""
    i = np.arange(nv)[:, None] * (nu + 1) + np.arange(nu)[None, :]
    a, b, c, d = i, i + 1, i + nu + 1, i + nu + 2
    return np.stack([a, c, b, b, c, d], axis=-1).reshape(-1, 3)


def _param_surface(fn, nu: int, nv: int, u_range, v_range):
    """Sample fn(u, v) -> (positions, normals) on a grid; uv in [0,1]^2."""
    u = np.linspace(u_range[0], u_range[1], nu + 1)
    v = np.linspace(v_range[0], v_range[1], nv + 1)
    uu, vv = np.meshgrid(u, v)
    pos, nrm = fn(uu, vv)
    tex = np.stack(
        [np.broadcast_to(np.linspace(0, 1, nu + 1), uu.shape),
         np.broadcast_to(np.linspace(0, 1, nv + 1)[:, None], uu.shape)],
        axis=-1,
    )
    return (
        pos.reshape(-1, 3).astype(np.float32),
        nrm.reshape(-1, 3).astype(np.float32),
        tex.reshape(-1, 2).astype(np.float32),
        _grid_indices(nu, nv).astype(np.uint32),
    )


def _sphere(nu, nv, radius, theta=(0.05, np.pi - 0.05), phi=(0, 2 * np.pi)):
    def fn(p, t):
        n = np.stack(
            [np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1
        )
        return n * radius, n

    return _param_surface(fn, nu, nv, phi, theta)


def _torus(nu, nv, major, minor):
    def fn(p, t):
        ring = np.stack([np.cos(p), np.zeros_like(p), np.sin(p)], -1)
        n = ring * np.cos(t)[..., None] + np.stack(
            [np.zeros_like(t), np.sin(t), np.zeros_like(t)], -1
        )
        return ring * major + n * minor, n

    return _param_surface(fn, nu, nv, (0, 2 * np.pi), (0, 2 * np.pi))


def _cylinder(nu, nv, radius, height):
    def fn(p, h):
        n = np.stack([np.cos(p), np.zeros_like(p), np.sin(p)], -1)
        return n * radius + np.stack(
            [np.zeros_like(h), h, np.zeros_like(h)], -1
        ), n

    return _param_surface(fn, nu, nv, (0, 2 * np.pi), (0, height))


def _disk(nu, nv, radius, y, up):
    def fn(p, r):
        pos = np.stack([r * np.cos(p), np.full_like(r, y), r * np.sin(p)], -1)
        n = np.broadcast_to(np.array([0.0, 1.0 if up else -1.0, 0.0]),
                            pos.shape)
        return pos, n

    pos, nrm, uv, idx = _param_surface(fn, nu, nv, (0, 2 * np.pi),
                                       (0.02 * radius, radius))
    if not up:
        idx = idx[:, ::-1]
    return pos, nrm, uv, np.ascontiguousarray(idx)


def _merge(*parts):
    pos, nrm, uv, idx = [], [], [], []
    base = 0
    for p, n, t, i in parts:
        pos.append(p)
        nrm.append(n)
        uv.append(t)
        idx.append(i + base)
        base += len(p)
    return (np.concatenate(pos), np.concatenate(nrm), np.concatenate(uv),
            np.concatenate(idx).astype(np.uint32))


def seeded_meshes(size: str = "full"):
    """The seeded scene's meshes: list of (name, material, (pos, nrm, uv,
    idx), node translation). Deterministic; no randomness in geometry."""
    s = SCENE_SIZES[size][0]

    def n(x):
        return max(int(round(x * s)), 3)

    pedestal = _merge(
        _cylinder(n(256), n(40), 0.22, 0.12),
        _disk(n(256), n(8), 0.22, 0.12, True),
        _disk(n(256), n(8), 0.22, 0.0, False),
    )
    return [
        ("pedestal", 0, pedestal, (0.0, 0.0, 0.0)),
        ("shell", 1, _sphere(n(160), n(120), 0.16), (0.0, 0.34, 0.0)),
        ("hoses", 2, _torus(n(192), n(48), 0.17, 0.025), (0.0, 0.2, 0.0)),
        ("straps", 3, _cylinder(n(200), n(20), 0.18, 0.08), (0.0, 0.24, 0.0)),
        ("lenses", 4, _merge(
            *[(p + np.array([dx, 0.0, 0.0], np.float32), nn, t, i)
              for dx in (-0.06, 0.06)
              for p, nn, t, i in [_sphere(n(48), n(32), 0.035)]]
        ), (0.0, 0.36, 0.15)),
        ("visor", 5, _sphere(n(96), n(48), 0.175, theta=(0.9, 1.9),
                             phi=(0.3 * np.pi, 0.7 * np.pi)),
         (0.0, 0.34, 0.0)),
    ]


# (name, base rgb, roughness, metallic, alpha mode, base alpha)
_MATERIALS = [
    ("wood", (0.45, 0.28, 0.15), 0.75, 0.0, "OPAQUE", 1.0),
    ("metal", (0.55, 0.58, 0.52), 0.35, 1.0, "OPAQUE", 1.0),
    ("rubber", (0.08, 0.08, 0.09), 0.9, 0.0, "OPAQUE", 1.0),
    ("leather_mask", (0.35, 0.22, 0.12), 0.6, 0.0, "MASK", 1.0),
    ("lens", (0.02, 0.02, 0.03), 0.1, 0.0, "OPAQUE", 1.0),
    ("glass_blend", (0.6, 0.75, 0.8), 0.05, 0.0, "BLEND", 0.4),
]


def _smooth_noise(rng, edge: int, cells: int) -> np.ndarray:
    """(edge, edge) value noise in [0, 1): bilinear upsampled random grid."""
    grid = rng.random((cells + 1, cells + 1), dtype=np.float32)
    x = np.linspace(0, cells, edge, endpoint=False, dtype=np.float32)
    i = x.astype(np.int32)
    f = x - i
    rows = grid[i] * (1 - f)[:, None] + grid[i + 1] * f[:, None]
    return rows[:, i] * (1 - f)[None, :] + rows[:, i + 1] * f[None, :]


def _material_textures(rng, mat, edge: int):
    """(base colour RGBA, normal RGB, metallic-roughness RGB) uint8."""
    _name, rgb, rough, metal, mode, alpha = mat
    noise = _smooth_noise(rng, edge, 16)
    fine = _smooth_noise(rng, edge, 64)
    shade = 0.75 + 0.5 * (0.6 * noise + 0.4 * fine - 0.5)
    base = np.empty((edge, edge, 4), np.float32)
    base[..., :3] = np.clip(np.asarray(rgb, np.float32) * shade[..., None],
                            0, 1)
    base[..., 3] = alpha
    if mode == "MASK":
        # punched holes: alpha 0 inside a regular grid of disks
        y, x = np.mgrid[0:edge, 0:edge].astype(np.float32) / edge
        d = np.hypot((x * 8) % 1 - 0.5, (y * 8) % 1 - 0.5)
        base[..., 3] = np.where(d < 0.25, 0.0, 1.0)
    elif mode == "BLEND":
        base[..., 3] = np.clip(alpha + 0.2 * (noise - 0.5), 0.05, 1.0)
    height = 0.7 * noise + 0.3 * fine
    gy, gx = np.gradient(height * edge / 64.0)
    nrm = np.stack([-gx, -gy, np.ones_like(gx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mr = np.zeros((edge, edge, 3), np.float32)
    mr[..., 1] = np.clip(rough + 0.2 * (fine - 0.5), 0.02, 1.0)
    mr[..., 2] = metal
    to8 = lambda a: (np.clip(a, 0, 1) * 255 + 0.5).astype(np.uint8)  # noqa: E731
    return to8(base), to8(nrm * 0.5 + 0.5), to8(mr)


def _look_at_quat(eye, target):
    """Quaternion (xyzw) rotating a glTF camera (looking down -Z, +Y up)
    to look from eye at target."""
    f = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    f /= np.linalg.norm(f)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    m = np.stack([r, u, -f], axis=1)  # columns: camera x, y, z in world
    w = np.sqrt(max(1.0 + m[0, 0] + m[1, 1] + m[2, 2], 1e-12)) / 2
    return [
        float((m[2, 1] - m[1, 2]) / (4 * w)),
        float((m[0, 2] - m[2, 0]) / (4 * w)),
        float((m[1, 0] - m[0, 1]) / (4 * w)),
        float(w),
    ]


def write_seeded_scene(out_dir: str, size: str = "full", seed: int = 0) -> str:
    """Write the seeded glTF 2.0 scene (JSON + .bin + PNG textures) into
    out_dir and return the .gltf path. Same (size, seed) -> same bytes.

    Six meshes on six nodes (pedestal, shell, hoses, straps, lenses,
    visor), six PBR materials each with base-colour, normal and
    metallic-roughness textures (one alpha-mask, one alpha-blend), a
    directional and two point lights, a camera, and one node animation
    (the visor swings open)."""
    import json

    from .io.image import encode_png

    rng = np.random.default_rng(seed)
    edge = SCENE_SIZES[size][1]
    os.makedirs(out_dir, exist_ok=True)
    blob = bytearray()
    views, accessors = [], []

    def add(arr: np.ndarray, comp: int, kind: str, target=None, bounds=False):
        arr = np.ascontiguousarray(arr)
        while len(blob) % 4:
            blob.append(0)
        view = {"buffer": 0, "byteOffset": len(blob),
                "byteLength": arr.nbytes}
        if target is not None:
            view["target"] = target
        blob.extend(arr.tobytes())
        views.append(view)
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": int(arr.shape[0]), "type": kind}
        if bounds:
            acc["min"] = [float(x) for x in np.atleast_1d(arr.min(axis=0))]
            acc["max"] = [float(x) for x in np.atleast_1d(arr.max(axis=0))]
        accessors.append(acc)
        return len(accessors) - 1

    meshes, nodes = [], []
    for name, mat, (pos, nrm, uv, idx), trans in seeded_meshes(size):
        prim = {
            "attributes": {
                "POSITION": add(pos, 5126, "VEC3", 34962, bounds=True),
                "NORMAL": add(nrm, 5126, "VEC3", 34962),
                "TEXCOORD_0": add(uv, 5126, "VEC2", 34962),
            },
            "indices": add(idx.reshape(-1), 5125, "SCALAR", 34963),
            "material": mat,
        }
        meshes.append({"name": name, "primitives": [prim]})
        nodes.append({"name": name, "mesh": len(meshes) - 1,
                      "translation": list(trans)})

    images, textures, materials = [], [], []
    for mi, mat in enumerate(_MATERIALS):
        maps = _material_textures(rng, mat, edge)
        for kind, img in zip(("basecolor", "normal", "mr"), maps):
            uri = f"{mat[0]}_{kind}.png"
            with open(os.path.join(out_dir, uri), "wb") as f:
                f.write(encode_png(img, level=1))
            images.append({"uri": uri})
            textures.append({"source": len(images) - 1, "sampler": 0})
        t0 = 3 * mi
        m = {
            "name": mat[0],
            "pbrMetallicRoughness": {
                "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                "baseColorTexture": {"index": t0},
                "metallicFactor": 1.0,
                "roughnessFactor": 1.0,
                "metallicRoughnessTexture": {"index": t0 + 2},
            },
            "normalTexture": {"index": t0 + 1},
        }
        if mat[4] != "OPAQUE":
            m["alphaMode"] = mat[4]
        if mat[4] == "MASK":
            m["alphaCutoff"] = 0.5
        materials.append(m)

    # lights and camera
    eye, target = (0.62, 0.48, 0.72), (0.0, 0.28, 0.0)
    nodes += [
        {"name": "sun", "rotation": [-0.3535534, 0.3535534, 0.1464466,
                                     0.8535534],
         "extensions": {"KHR_lights_punctual": {"light": 0}}},
        {"name": "lamp_a", "translation": [0.4, 0.6, 0.4],
         "extensions": {"KHR_lights_punctual": {"light": 1}}},
        {"name": "lamp_b", "translation": [-0.5, 0.4, 0.2],
         "extensions": {"KHR_lights_punctual": {"light": 2}}},
        {"name": "camera", "camera": 0, "translation": list(eye),
         "rotation": _look_at_quat(eye, target)},
    ]
    # the visor swings 0 -> 20 degrees about x over two seconds and back
    times = np.array([0.0, 1.0, 2.0], np.float32)
    ang = np.radians([0.0, 20.0, 0.0]) / 2
    quats = np.stack(
        [np.sin(ang), np.zeros(3), np.zeros(3), np.cos(ang)], -1
    ).astype(np.float32)
    anim = {
        "name": "visor_swing",
        "samplers": [{"input": add(times, 5126, "SCALAR", bounds=True),
                      "output": add(quats, 5126, "VEC4"),
                      "interpolation": "LINEAR"}],
        "channels": [{"sampler": 0, "target": {"node": 5,
                                                "path": "rotation"}}],
    }

    bin_name = "scene.bin"
    with open(os.path.join(out_dir, bin_name), "wb") as f:
        f.write(bytes(blob))
    doc = {
        "asset": {"version": "2.0", "generator": SCENE_GENERATOR},
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "directional", "color": [1.0, 0.96, 0.9],
             "intensity": 3.0},
            {"type": "point", "color": [1.0, 0.85, 0.7], "intensity": 2.0,
             "range": 3.0},
            {"type": "point", "color": [0.6, 0.75, 1.0], "intensity": 1.5,
             "range": 3.0},
        ]}},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "materials": materials,
        "textures": textures,
        "images": images,
        "samplers": [{"magFilter": 9729, "minFilter": 9987,
                      "wrapS": 10497, "wrapT": 10497}],
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": float(np.radians(45.0)), "znear": 0.01, "zfar": 50.0}}],
        "animations": [anim],
        "buffers": [{"uri": bin_name, "byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    path = os.path.join(out_dir, "scene.gltf")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path


def seeded_scene_path(size: str = "full", seed: int = 0,
                      root: str | None = None) -> str:
    """Path of the seeded scene under generated/ (gitignored), written on
    first use and whenever the generator version changed."""
    import json
    import shutil
    import tempfile

    root = GENERATED_DIR if root is None else root
    out_dir = os.path.join(root, f"seeded_{size}_{seed}")
    path = os.path.join(out_dir, "scene.gltf")
    try:
        with open(path) as f:
            if json.load(f)["asset"]["generator"] == SCENE_GENERATOR:
                return path
    except (OSError, ValueError, KeyError):
        pass
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".seeded_{size}_{seed}_", dir=root)
    write_seeded_scene(tmp, size, seed)
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        os.rename(tmp, out_dir)
    except OSError:  # another process published it first
        shutil.rmtree(tmp, ignore_errors=True)
    return path


# ---------------------------------------------------------------------------
# Tracer test fixtures: random cluster soup and its brute-force answer
# ---------------------------------------------------------------------------


def random_cluster_soup(n_clusters=4, seed=0):
    """Random triangle soup padded into 128-slot cluster slabs: (tris
    {"v0", "e1", "e2"}, cluster AABB min, max) as device arrays."""
    import jax.numpy as jnp

    from .ops.trace import CLUSTER_PAD

    rng = np.random.default_rng(seed)
    S = n_clusters * CLUSTER_PAD
    v0 = np.zeros((S, 3), np.float32)
    e1 = np.zeros((S, 3), np.float32)
    e2 = np.zeros((S, 3), np.float32)
    wc_min = np.zeros((n_clusters, 3), np.float32)
    wc_max = np.zeros((n_clusters, 3), np.float32)
    for c in range(n_clusters):
        center = rng.uniform(-4, 4, 3)
        n_real = rng.integers(8, CLUSTER_PAD - 3)
        base = c * CLUSTER_PAD
        a = center + rng.normal(0, 1.0, (n_real, 3))
        b = a + rng.normal(0, 0.5, (n_real, 3))
        d = a + rng.normal(0, 0.5, (n_real, 3))
        v0[base : base + n_real] = a
        e1[base : base + n_real] = b - a
        e2[base : base + n_real] = d - a
        pts = np.concatenate([a, b, d])
        wc_min[c] = pts.min(axis=0)
        wc_max[c] = pts.max(axis=0)
    return (
        {"v0": jnp.asarray(v0), "e1": jnp.asarray(e1), "e2": jnp.asarray(e2)},
        jnp.asarray(wc_min),
        jnp.asarray(wc_max),
    )


def brute_force_closest(tris, o, d, t_min, t_max):
    """Every ray against every triangle slot with Moller-Trumbore:
    (closest slot index or -1, its t or inf)."""
    from .ops.intersect import moller_trumbore

    hit, t, u, v = moller_trumbore(
        np.asarray(o)[:, None, :],
        np.asarray(d)[:, None, :],
        np.asarray(tris["v0"])[None],
        np.asarray(tris["e1"])[None],
        np.asarray(tris["e2"])[None],
        t_min,
        t_max,
    )
    t = np.where(np.asarray(hit), np.asarray(t), np.inf)
    best = np.argmin(t, axis=1)
    bt = t[np.arange(len(best)), best]
    return np.where(np.isfinite(bt), best, -1), bt
