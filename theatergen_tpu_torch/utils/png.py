"""A small PNG codec on ``zlib`` and ``struct``, for the character DB and
the CLI's images (the JAX package uses PIL, which the port does not
need).

:func:`write_png` writes 8-bit RGB, every row with filter 0 (none).
:func:`read_png` reads 8-bit, non-interlaced greyscale, grey+alpha, RGB
and RGBA files with any of the five row filters (PIL and libpng choose a
filter per row), and returns RGB.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 ``[H, W, 3]`` → PNG bytes."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png: want uint8 [H, W, 3], got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for x in range(len(line)):
        a = line[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[x] = (line[x] + pred) & 0xFF


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        line = np.frombuffer(data, np.uint8, stride, pos + 1).copy()
        pos += stride + 1
        if ftype == 1:        # Sub: running sum along x, per channel
            pad = (-stride) % bpp
            cols = np.concatenate([line, np.zeros(pad, np.uint8)])
            cols = cols.reshape(-1, bpp).astype(np.int64)
            line = (np.cumsum(cols, axis=0) % 256).astype(np.uint8)
            line = line.reshape(-1)[:stride]
        elif ftype == 2:      # Up
            line = line + prev
        elif ftype == 3:      # Average
            buf = bytearray(line.tobytes())
            pv = prev.tobytes()
            for x in range(stride):
                a = buf[x - bpp] if x >= bpp else 0
                buf[x] = (buf[x] + ((a + pv[x]) >> 1)) & 0xFF
            line = np.frombuffer(bytes(buf), np.uint8)
        elif ftype == 4:      # Paeth
            buf = bytearray(line.tobytes())
            _paeth_row(buf, prev.tobytes(), bpp)
            line = np.frombuffer(bytes(buf), np.uint8)
        elif ftype != 0:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = line
        prev = out[y]
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes → uint8 ``[H, W, 3]``; alpha is dropped, grey repeated."""
    if blob[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG: only 8-bit, non-interlaced grey/RGB(A) "
                         f"files are read (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ch in (1, 2):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def to_uint8(image: np.ndarray) -> np.ndarray:
    """A float image in [0, 1] → uint8, clipped and truncated as the JAX
    package's ``(np.clip(x, 0, 1) * 255).astype(np.uint8)``."""
    return (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8)
