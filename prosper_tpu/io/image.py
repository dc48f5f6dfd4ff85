"""Image file IO: PNG read/write with zlib + numpy, JPEG through PIL when
it is installed, and raw float dumps.

Replaces the reference's stb_image load path (Texture.cpp:166-298) and the
screenshot/present output (we are headless: frames are written to disk,
SURVEY.md §7 "ImGui app → headless CLI").

The PNG codec covers what glTF scenes use: 8- and 16-bit gray, gray +
alpha, RGB and RGBA, palette images (with tRNS alpha) and 1/2/4-bit gray
or palette, all five row filters; not Adam7 interlacing. The writer emits
8-bit RGB/RGBA with the "Up" filter, which the reader undoes in one
vectorized pass.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples/pixel


def _chunks(data: bytes, name: str):
    if data[:8] != PNG_MAGIC:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def png_size(data: bytes, name: str = "<png>") -> tuple[int, int]:
    """(height, width) from the IHDR chunk, without decoding pixels."""
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            return h, w
    raise ValueError(f"{name}: PNG without IHDR")


def _paeth_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = raw.astype(np.int32)
    up = prev.astype(np.int32)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out.astype(np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: raw is (h, 1 + stride) with the filter
    type in column 0. None/Sub/Up rows are vectorized; Average and Paeth
    are sequential within a row."""
    ftype = raw[:, 0]
    rows = raw[:, 1:].copy()
    if np.all(ftype == 0):
        return rows
    if np.all((ftype == 2) | (ftype == 0)) and np.all(ftype[1:] == 2):
        # Up on every row after the first: a running sum down columns
        return np.cumsum(rows, axis=0, dtype=np.uint8)
    out = np.zeros_like(rows)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        r = rows[y]
        f = int(ftype[y])
        if f == 0:
            cur = r
        elif f == 1:
            pad = (-stride) % bpp
            seq = np.concatenate([r, np.zeros(pad, np.uint8)])
            cur = np.cumsum(seq.reshape(-1, bpp), axis=0, dtype=np.uint8)
            cur = cur.reshape(-1)[:stride]
        elif f == 2:
            cur = (r.astype(np.uint16) + prev).astype(np.uint8)
        elif f == 3:
            cur = r.astype(np.int32)
            up = prev.astype(np.int32)
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
            cur = cur.astype(np.uint8)
        elif f == 4:
            cur = _paeth_row(r, prev, bpp)
        else:
            raise ValueError(f"PNG filter type {f} is invalid")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA (like stb with STBI_rgb_alpha)."""
    header = None
    palette = None
    trns = None
    idat = []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if interlace:
        raise NotImplementedError(f"{name}: interlaced PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: PNG color type {ctype} is invalid")
    ch = _CHANNELS[ctype]
    bits = depth * ch
    stride = (w * bits + 7) // 8
    bpp = max(bits // 8, 1)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(raw[: h * (stride + 1)].reshape(h, stride + 1), h,
                     stride, bpp)
    if depth == 16:
        px = rows.reshape(h, w, ch, 2)[..., 0]  # high byte
    elif depth == 8:
        px = rows.reshape(h, w, ch)
    else:  # 1/2/4-bit gray or palette
        per = 8 // depth
        bitsarr = np.unpackbits(rows, axis=1).reshape(h, stride * per, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bitsarr * weights).sum(axis=-1).astype(np.uint8)[:, :w, None]
        if ctype == 0:
            px = (px.astype(np.uint32) * 255 // ((1 << depth) - 1)).astype(
                np.uint8
            )
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        idx = px[..., 0]
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[: len(palette)]
            alpha[: len(t)] = t
        return np.concatenate([palette[idx], alpha[idx][..., None]], axis=-1)
    out = np.empty((h, w, 4), np.uint8)
    if ch in (1, 2):
        out[..., :3] = px[..., :1]
    else:
        out[..., :3] = px[..., :3]
    out[..., 3] = px[..., -1] if ch in (2, 4) else 255
    return out


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes (8-bit RGB/RGBA, "Up" filter)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png needs (H, W, 3|4), got {img.shape}")
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]  # uint8 wraps mod 256
    ftype = np.full((h, 1), 2, np.uint8)
    ftype[0] = 0
    payload = zlib.compress(np.concatenate([ftype, up], axis=1).tobytes(),
                            level)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if ch == 4 else 2, 0, 0, 0)
    return (
        PNG_MAGIC
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", payload)
        + chunk(b"IEND", b"")
    )


def decode_image_bytes(data: bytes, name: str) -> np.ndarray:
    """PNG or JPEG bytes -> (H, W, 4) uint8. JPEG needs PIL."""
    if data[:8] == PNG_MAGIC:
        return decode_png(data, name)
    import io

    im = _pil_open(io.BytesIO(data), name)
    with im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def image_bytes_size(data: bytes, name: str) -> tuple[int, int]:
    """(height, width) of PNG or JPEG bytes without decoding pixels."""
    if data[:8] == PNG_MAGIC:
        return png_size(data, name)
    import io

    with _pil_open(io.BytesIO(data), name) as im:
        w, h = im.size
    return h, w


def _pil_open(fp, name: str):
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{name}: only PNG decodes without PIL; install Pillow to read "
            "this image"
        ) from None
    return Image.open(fp)


def load_image_rgba8(path: str) -> np.ndarray:
    """Load png/jpg as (H, W, 4) uint8 (like stb with STBI_rgb_alpha)."""
    with open(path, "rb") as f:
        return decode_image_bytes(f.read(), path)


def resize_area(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Area-average resize of (H, W, C) uint8 to (h, w, C) (the max_dim
    downscale of texture loading)."""

    def weights(n_in: int, n_out: int) -> np.ndarray:
        edges = np.arange(n_out + 1) * (n_in / n_out)
        lo, hi = edges[:-1, None], edges[1:, None]
        x = np.arange(n_in)[None, :]
        overlap = np.clip(np.minimum(hi, x + 1) - np.maximum(lo, x), 0, None)
        return (overlap / overlap.sum(axis=1, keepdims=True)).astype(
            np.float32
        )

    wy = weights(img.shape[0], h)
    wx = weights(img.shape[1], w)
    out = np.einsum("yi,ijc,xj->yxc", wy, img.astype(np.float32), wx,
                    optimize=True)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3|4) uint8 or float in [0,1] to PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
        img = (img * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_npy(path: str, img: np.ndarray) -> None:
    """Raw float dump for goldens/debug (TextureDebug-equivalent)."""
    np.save(path, np.asarray(img))
