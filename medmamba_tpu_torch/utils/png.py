"""A small PNG codec on ``zlib`` and ``struct``, for the CLIs that write and
read images where PIL is not installed.

``encode`` writes 8-bit gray (H, W), RGB (H, W, 3) or RGBA (H, W, 4) uint8
arrays, unfiltered, in one IDAT chunk. ``decode`` reads 8-bit gray, RGB and
RGBA files that are not interlaced, with any of the five row filters, and
returns uint8 RGB as PIL's ``Image.open(f).convert("RGB")`` does: alpha is
dropped and gray is repeated into three channels. Anything else (palette,
gray with alpha, 16-bit, interlaced) raises :class:`Unsupported`.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples per pixel


class Unsupported(ValueError):
    """A valid PNG this decoder does not read."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 (H, W), (H, W, 3) or (H, W, 4) array."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"encode takes (H, W), (H, W, 3) or (H, W, 4), got "
                         f"{img.shape}")
    h, w, ch = img.shape
    colour = {1: 0, 3: 2, 4: 6}[ch]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * ch)], 1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2) of ``h`` rows of ``stride``
    bytes, ``bpp`` bytes per pixel."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:             # Sub: a running sum per byte position
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:             # Up
            cur = line + prev
        elif kind in (3, 4):        # Average, Paeth: byte by byte
            lst, up, res = line.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                a = res[i - bpp] if i >= bpp else 0
                c = up[i - bpp] if i >= bpp else 0
                pred = ((a + up[i]) >> 1 if kind == 3
                        else _paeth(a, up[i], c))
                res[i] = (lst[i] + pred) & 0xFF
            cur = np.array(res, np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def decode(data: bytes) -> np.ndarray:
    """uint8 RGB (H, W, 3) of an 8-bit gray, RGB or RGBA PNG that is not
    interlaced; raises :class:`Unsupported` for any other PNG and
    ValueError for data that is not a PNG."""
    if not is_png(data):
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise Unsupported(f"PNG bit depth {depth}, colour type {colour}, "
                          f"interlace {interlace}: not read here")
    ch = _CHANNELS[colour]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ch == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def load_rgb(data: bytes, size: int) -> np.ndarray:
    """The uint8 (size, size, 3) pixels the JAX CLIs take from an image
    file, ``Image.open(f).convert("RGB").resize((size, size), BILINEAR)``.
    A PNG that :func:`decode` reads and that is already size x size is
    decoded here (PIL's resize to the same size returns a copy); any other
    file goes through PIL, imported only then."""
    if is_png(data):
        try:
            img = decode(data)
        except Unsupported:
            img = None
        if img is not None and img.shape[:2] == (size, size):
            return img
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB").resize(
        (size, size), Image.BILINEAR)
    return np.array(img, np.uint8)
