"""PNG files without cv2: the frames the evaluation and the demo read, and
the overlays and frames they write.

The JAX package reads and writes them with `cv2.imread` / `cv2.imwrite`;
this is the part of those calls the port uses, on zlib, struct and numpy
alone. Readers: `read_png16` takes non-interlaced 16-bit grayscale images
(depth in millimetres), `read_png_rgb8` non-interlaced 8-bit RGB or RGBA
images (alpha dropped), `read_png8` 8-bit grayscale, RGB or RGBA images as
stored (a mask file), each with any of the five PNG row filters; every other
format raises. Writers: `write_png16`, `write_png_gray8`, `write_png_rgb8`,
filter 0 on every row. Colours are RGB here; the JAX package flips them to
and from cv2's BGR at its call sites.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter_slow(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4) rows: each byte depends on the byte one
    pixel (`bpp` bytes) to its left, so they are undone byte by byte."""
    cur = line.tolist()
    up = prior.tolist()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def _read_rows(path: str, formats) -> tuple:
    """The unfiltered pixel bytes (h, w * bpp) of a non-interlaced PNG whose
    (bit depth, colour type) is a key of `formats` (-> bytes per pixel), and
    that key."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, compression, filtering, interlace = header
    if (depth, color) not in formats or (compression, filtering, interlace) != (0, 0, 0):
        raise ValueError(f"{path}: only non-interlaced PNGs of (bit depth, colour type) in "
                         f"{sorted(formats)} are read here (bit depth {depth}, colour type "
                         f"{color}, interlace {interlace})")
    bpp = formats[(depth, color)]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of pixel data for a {w}x{h} image")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            lanes = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint32)
            cur = (lanes & 0xFF).astype(np.uint8).reshape(stride)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = _unfilter_slow(kind, line, prior, bpp)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[y] = cur
        prior = cur
    return out, (depth, color)


def read_png16(path: str) -> np.ndarray:
    """(H, W) uint16 pixels of a 16-bit grayscale PNG."""
    out, _ = _read_rows(path, {(16, 0): 2})
    return out.view(">u2").astype(np.uint16)


def read_png_rgb8(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB pixels of an 8-bit RGB or RGBA PNG (alpha dropped)."""
    out, (_, color) = _read_rows(path, {(8, 2): 3, (8, 6): 4})
    channels = 3 if color == 2 else 4
    return np.ascontiguousarray(out.reshape(out.shape[0], -1, channels)[:, :, :3])


def read_png8(path: str) -> np.ndarray:
    """The uint8 pixels of an 8-bit PNG as stored, as `cv2.imread(path, -1)`
    gives them but in RGB order: (H, W) gray, (H, W, 3) RGB or (H, W, 4)
    RGBA."""
    out, (_, color) = _read_rows(path, {(8, 0): 1, (8, 2): 3, (8, 6): 4})
    if color == 0:
        return out
    return out.reshape(out.shape[0], -1, 3 if color == 2 else 4)


def _write(path: str, rows: np.ndarray, depth: int, color: int) -> None:
    """A PNG of (H, W * bytes per pixel) big-endian rows, filter 0."""
    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    h = rows.shape[0]
    w = rows.shape[1] // ((depth // 8) * {0: 1, 2: 3}[color])
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_png16(path: str, img: np.ndarray) -> None:
    """A 16-bit grayscale PNG of (H, W) uint16 pixels."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint16:
        raise ValueError(f"write_png16 takes (H, W) uint16 pixels, got {img.shape} {img.dtype}")
    _write(path, img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1), 16, 0)


def write_png_gray8(path: str, img: np.ndarray) -> None:
    """An 8-bit grayscale PNG of (H, W) uint8 pixels."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"write_png_gray8 takes (H, W) uint8 pixels, got {img.shape} {img.dtype}")
    _write(path, np.ascontiguousarray(img), 8, 0)


def write_png_rgb8(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG of (H, W, 3) uint8 RGB pixels."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"write_png_rgb8 takes (H, W, 3) uint8 pixels, got {img.shape} {img.dtype}")
    _write(path, np.ascontiguousarray(img).reshape(img.shape[0], -1), 8, 2)
