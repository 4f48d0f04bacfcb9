"""Minimal PNG writer and reader (stdlib zlib + numpy), so the port needs no
image library: 8-bit RGB, no filtering on write; filter-0 rows on read (what
``save_png`` writes)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def save_png(path, image_uint8) -> None:
    """Write a [h, w, 3] uint8 array as a PNG (reference: output.png,
    main.cpp:57)."""
    img = np.ascontiguousarray(np.asarray(image_uint8, np.uint8))
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def load_png(path) -> np.ndarray:
    """Read a PNG written by ``save_png`` back to [h, w, 3] uint8."""
    data = open(path, "rb").read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        typ, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if typ == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color_type != 2:
                raise ValueError(f"{path}: only 8-bit RGB PNGs are read")
        elif typ == b"IDAT":
            idat += body
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered PNG rows are not supported")
    return rows[:, 1:].reshape(h, w, 3).copy()
