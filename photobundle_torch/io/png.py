"""8-bit grayscale PNG, read and written with the standard library.

The card's machine has neither OpenCV nor PIL, so `io/kitti.py` falls back
to this decoder. It reads exactly one kind of file, the kind KITTI's
grayscale sequences are: 8-bit grayscale (colour type 0), not interlaced,
any of the five row filters. Anything else raises ValueError. The writer
emits that kind (every row unfiltered).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    """(type, body) of every chunk, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError("PNG chunk truncated or corrupt")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray):
    """One row of raw bytes from its filtered bytes (one byte per pixel)."""
    if ftype == 0:                                   # None
        return line
    if ftype == 1:                                   # Sub
        return np.cumsum(line, dtype=np.uint8)
    if ftype == 2:                                   # Up
        return line + prev
    if ftype not in (3, 4):
        raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
    cur, up = line.tolist(), prev.tolist()
    a = c = 0                    # the reconstructed left and upper-left bytes
    for x, b in enumerate(up):
        if ftype == 3:                               # Average
            pred = (a + b) >> 1
        else:                                        # Paeth
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        a = (cur[x] + pred) & 0xFF
        cur[x] = a
        c = b
    return np.asarray(cur, np.uint8)


def read_png_gray(path: str) -> np.ndarray:
    """(H, W) uint8 pixels of an 8-bit grayscale, non-interlaced PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if (depth, colour, compression, filtering, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit grayscale non-interlaced PNGs "
                         f"are decoded here (bit depth {depth}, colour type "
                         f"{colour}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (w + 1)}")
    rows = raw.reshape(h, w + 1)
    out = np.empty((h, w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev)
    return out


def write_png_gray(path: str, image: np.ndarray) -> None:
    """Write (H, W) uint8 pixels as an 8-bit grayscale PNG."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 2:
        raise ValueError("write_png_gray takes an (H, W) uint8 array")
    h, w = image.shape
    rows = np.zeros((h, w + 1), np.uint8)           # filter byte 0: None
    rows[:, 1:] = image

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
