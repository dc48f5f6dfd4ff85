import struct

import numpy as np
import pytest

from prosper_tpu.io import dds
from prosper_tpu.io.image import load_image_rgba8, write_png


def _encode_r9g9b9e5(rgb: np.ndarray) -> np.ndarray:
    """float (..., 3) in [0, 1) -> shared-exponent uint32 (exponent 15:
    value = mantissa / 512)."""
    m = np.clip(np.round(rgb * 512.0), 0, 511).astype(np.uint32)
    return m[..., 0] | (m[..., 1] << 9) | (m[..., 2] << 18) | (15 << 27)


def _write_lut_dds(path, lut):
    """A 48^3 R9G9B9E5 3D DDS in the layout of tony_mc_mapface.dds."""
    d = lut.shape[0]
    hdr = [124, 0x1007 | 0x800000, d, d, d * 4, d, 1] + [0] * 11
    pf = [32, 0x4, int.from_bytes(b"DX10", "little"), 0, 0, 0, 0, 0]
    caps = [0x1000, 0x200000, 0, 0, 0]
    with open(path, "wb") as f:
        f.write(b"DDS ")
        f.write(struct.pack("<31I", *(hdr + pf + caps)))
        f.write(struct.pack("<5I", dds.DXGI_R9G9B9E5, 4, 0, 1, 0))
        f.write(_encode_r9g9b9e5(lut).astype("<u4").tobytes())


def test_read_tony_mc_mapface_lut(tmp_path):
    """The Tony McMapface LUT format (R9G9B9E5 3D DDS) reads through the
    --lut path; a LUT file holding the generated identity LUT loads back
    as generated_lut() to 9-bit precision."""
    from prosper_tpu.ops.tonemap import generated_lut, load_tony_mc_mapface

    ramp = np.arange(48, dtype=np.float32) / 47.0
    z, y, x = np.meshgrid(ramp, ramp, ramp, indexing="ij")
    p = str(tmp_path / "lut.dds")
    _write_lut_dds(p, np.stack([x, y, z], -1) * (511.0 / 512.0))
    img = dds.read_dds(p)
    assert img.dxgi_format == dds.DXGI_R9G9B9E5
    assert (img.width, img.height, img.depth) == (48, 48, 48)
    lut = img.mips[0]
    assert lut.shape == (48, 48, 48, 3)
    assert lut.dtype == np.float32
    assert lut.min() >= 0.0 and lut.max() <= 1.0
    np.testing.assert_allclose(
        load_tony_mc_mapface(p), generated_lut(), atol=2.0 / 512.0
    )


def test_dds_rgba8_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    m0 = rng.integers(0, 255, (16, 16, 4), dtype=np.uint8)
    m1 = rng.integers(0, 255, (8, 8, 4), dtype=np.uint8)
    p = str(tmp_path / "t.dds")
    dds.write_dds_rgba8(p, [m0, m1], srgb=True)
    img = dds.read_dds(p)
    assert img.dxgi_format == dds.DXGI_R8G8B8A8_SRGB
    assert len(img.mips) == 2
    np.testing.assert_array_equal(img.mips[0], m0)
    np.testing.assert_array_equal(img.mips[1], m1)


def test_png_roundtrip(tmp_path):
    img = np.zeros((4, 4, 3), np.float32)
    img[0, 0] = [1, 0.5, 0]
    p = str(tmp_path / "t.png")
    write_png(p, img)
    back = load_image_rgba8(p)
    assert back.shape == (4, 4, 4)
    assert back[0, 0, 0] == 255


def test_load_seeded_scene_texture():
    import json
    import os

    from prosper_tpu.testing import seeded_scene_path

    path = seeded_scene_path("small")
    with open(path) as f:
        uri = json.load(f)["images"][0]["uri"]
    tex = load_image_rgba8(os.path.join(os.path.dirname(path), uri))
    assert tex.shape == (64, 64, 4)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 33)])
def test_png_codec_roundtrip(tmp_path, channels, shape):
    from prosper_tpu.io.image import decode_png, encode_png

    rng = np.random.default_rng(channels * 100 + shape[1])
    img = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    back = decode_png(encode_png(img))
    np.testing.assert_array_equal(back[..., :channels], img)
    if channels == 3:
        assert (back[..., 3] == 255).all()


def _png_bytes(rows: bytes, w: int, h: int, ctype: int, depth: int = 8,
               extra: bytes = b"") -> bytes:
    import zlib

    from prosper_tpu.io.image import PNG_MAGIC

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (PNG_MAGIC + chunk(b"IHDR", ihdr) + extra
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _filter_row(ftype: int, cur: np.ndarray, prev: np.ndarray, bpp: int):
    c = cur.astype(np.int32)
    p = prev.astype(np.int32)
    out = np.zeros_like(c)
    for i in range(len(c)):
        a = c[i - bpp] if i >= bpp else 0
        b = p[i]
        cc = p[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) // 2
        else:
            q = a + b - cc
            pa, pb, pc = abs(q - a), abs(q - b), abs(q - cc)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
        out[i] = (c[i] - pred) & 0xFF
    return bytes([ftype]) + out.astype(np.uint8).tobytes()


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decode_row_filters(ftype):
    """Every PNG row filter (None/Sub/Up/Average/Paeth) decodes."""
    from prosper_tpu.io.image import decode_png

    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
    rows = b""
    prev = np.zeros(18, np.uint8)
    for y in range(5):
        cur = img[y].reshape(-1)
        rows += _filter_row(ftype, cur, prev, 3)
        prev = cur
    got = decode_png(_png_bytes(rows, 6, 5, 2))
    np.testing.assert_array_equal(got[..., :3], img)


def test_png_decode_palette_with_alpha():
    from prosper_tpu.io.image import decode_png

    import zlib  # noqa: F401

    plte = bytes([10, 20, 30, 200, 100, 50])
    trns = bytes([0, 255])

    def chunk(kind, body):
        import zlib as z

        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", z.crc32(kind + body) & 0xFFFFFFFF))

    idx = np.array([[0, 1, 1], [1, 0, 0]], np.uint8)
    rows = b"".join(bytes([0]) + r.tobytes() for r in idx)
    got = decode_png(_png_bytes(
        rows, 3, 2, 3, extra=chunk(b"PLTE", plte) + chunk(b"tRNS", trns)
    ))
    assert got.shape == (2, 3, 4)
    np.testing.assert_array_equal(got[0, 0], [10, 20, 30, 0])
    np.testing.assert_array_equal(got[0, 1], [200, 100, 50, 255])


def test_jpeg_without_pil_names_the_file(monkeypatch):
    import builtins

    from prosper_tpu.io.image import decode_image_bytes

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="photo.jpg"):
        decode_image_bytes(b"\xff\xd8\xff\xe0not-really-a-jpeg", "photo.jpg")


def test_resize_area_averages_blocks():
    from prosper_tpu.io.image import resize_area

    img = np.arange(16 * 16 * 4, dtype=np.uint8).reshape(16, 16, 4)
    got = resize_area(img, 4, 4)
    want = img.reshape(4, 4, 4, 4, 4).mean(axis=(1, 3))
    np.testing.assert_allclose(got, want, atol=0.5)


def test_mesh_quantization_roundtrip():
    """packMeshData-analog quantization (Mesh.hpp:11-15 parity): f16x4
    positions, 10-10-10-2 snorm normals/tangents, f16 uv, u16 indices."""
    import numpy as np

    from prosper_tpu.scene.world import (
        dequantize_mesh_arrays,
        quantize_mesh_arrays,
    )

    rng = np.random.default_rng(3)
    V, T = 777, 400
    n = rng.normal(size=(V, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t3 = rng.normal(size=(V, 3)).astype(np.float32)
    t3 /= np.linalg.norm(t3, axis=1, keepdims=True)
    a = {
        "positions": rng.uniform(-2, 2, (V, 3)).astype(np.float32),
        "normals": n,
        "tangents": np.concatenate(
            [t3, rng.choice([-1.0, 1.0], (V, 1))], 1
        ).astype(np.float32),
        "uv0": rng.uniform(0, 1, (V, 2)).astype(np.float32),
        "tri_vidx": rng.integers(0, V, (T, 3)).astype(np.uint32),
        "cluster_offset": np.zeros(2, np.uint32),
    }
    q = quantize_mesh_arrays(a)
    assert q["positions_f16"].dtype == np.float16
    assert q["normals_1010102"].dtype == np.uint32
    assert q["tri_vidx"].dtype == np.uint16  # V <= 65535
    d = dequantize_mesh_arrays(q)
    assert np.abs(d["positions"] - a["positions"]).max() < 1e-3
    dn = d["normals"] / np.linalg.norm(d["normals"], axis=1, keepdims=True)
    assert (dn * a["normals"]).sum(1).min() > 0.99999
    dt = d["tangents"][:, :3]
    dt = dt / np.linalg.norm(dt, axis=1, keepdims=True)
    assert (dt * a["tangents"][:, :3]).sum(1).min() > 0.99999
    assert np.array_equal(
        np.sign(d["tangents"][:, 3]), np.sign(a["tangents"][:, 3])
    )
    assert np.array_equal(d["tri_vidx"], a["tri_vidx"])
    assert np.abs(d["uv0"] - a["uv0"]).max() < 5e-4
