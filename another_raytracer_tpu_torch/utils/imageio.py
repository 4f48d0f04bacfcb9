"""Host-side image IO, so the port needs no image library: a PNG encoder
(8-bit RGB, no filtering), a stdlib PNG decoder (port of the JAX package's
``utils.imageio._decode_png``) and JPEG through the port's native decoder
(``utils/native.py``); they read the port's output and the texture maps
of meshes and scenes."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def save_png(path, image_uint8) -> None:
    """Write a [h, w, 3] uint8 array as a PNG (reference: output.png,
    main.cpp:57)."""
    data = encode_png(image_uint8)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(image_uint8) -> bytes:
    """A [h, w, 3] uint8 array as the bytes of a PNG file."""
    img = np.ascontiguousarray(np.asarray(image_uint8, np.uint8))
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolor
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def load_png(path) -> np.ndarray:
    """Read an 8-bit PNG to [h, w, 3] uint8 (``_decode_png``)."""
    data = open(path, "rb").read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    return _decode_png(data)


def load_image(path) -> "np.ndarray | None":
    """Decode an image file to [h, w, 3] float64 in [0, 1] (the reference's
    stb_image role): PNG with the stdlib decoder, JPEG with the native one.
    None for a missing file: callers take the reference's solid-cyan
    fallback texture (texture.h:91-92).  A file that exists and cannot be
    decoded raises ValueError instead of quietly rendering cyan."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIGNATURE:
        img = _decode_png(data)
    elif data[:2] == b"\xff\xd8":
        from another_raytracer_tpu_torch.utils import native

        img = native.decode_jpeg(path)
    else:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    return img.astype(np.float64) / 255.0


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal stdlib PNG decoder to [h, w, 3] uint8: 8-bit gray / gray +
    alpha / RGB / RGBA, all five filter types, no interlacing or palette."""
    pos = 8
    idat = b""
    w = h = nchan = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        typ = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if typ == b"IHDR":
            w, h, depth, color_type, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", body)
            if depth != 8 or interlace:
                raise ValueError("only 8-bit non-interlaced PNG supported")
            nchan = {0: 1, 2: 3, 4: 2, 6: 4}.get(color_type)
            if nchan is None:
                raise ValueError("palette PNG not supported")
        elif typ == b"IDAT":
            idat += body
        elif typ == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * nchan
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    p = 0
    for row in range(h):
        f = raw[p]
        line = np.frombuffer(raw, np.uint8, stride, p + 1).astype(np.int64)
        p += 1 + stride
        # Filters 0 (none), 1 (sub: a per-channel running sum) and 2 (up)
        # unfilter a row at once; 3 (average) and 4 (Paeth) depend on the
        # decoded previous pixel, so they walk the pixels.
        if f == 0:
            cur = line
        elif f == 1:
            cur = np.cumsum(line.reshape(w, nchan), axis=0).reshape(stride) & 0xFF
        elif f == 2:
            cur = (line + prev) & 0xFF
        else:
            px_line = line.reshape(w, nchan)
            px_prev = prev.reshape(w, nchan)
            px_cur = np.zeros((w, nchan), np.int64)
            a = np.zeros(nchan, np.int64)
            c = np.zeros(nchan, np.int64)
            for i in range(w):
                b = px_prev[i]
                if f == 3:
                    x = px_line[i] + (a + b) // 2
                else:  # Paeth
                    pp = a + b - c
                    pa, pb, pc = np.abs(pp - a), np.abs(pp - b), np.abs(pp - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                    x = px_line[i] + pred
                a = px_cur[i] = x & 0xFF
                c = b
            cur = px_cur.reshape(stride)
        out[row] = cur
        prev = cur
    img = out.reshape(h, w, nchan)
    if nchan <= 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3].copy()
