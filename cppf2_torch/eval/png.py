"""Reader for the PNG files of a REAL275 frame: the 16-bit grayscale depth
map and the 8-bit colour image.

The JAX driver reads them with `cv2.imread`; this is the part of that call
the evaluation uses, on zlib and numpy alone. `read_png16` takes
non-interlaced 16-bit grayscale images, `read_png_rgb8` non-interlaced 8-bit
RGB or RGBA images (alpha dropped), each with any of the five PNG row
filters; every other format raises.
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
