"""Readers of the input files: Wavefront ``.obj`` with its ``.mtl`` and a
PNG ``map_Kd``.  Faces are fan-triangulated (0, i, i + 1); indices are
1-based, negative ones count from the end."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def read_mtl(path: Path) -> dict:
    """{name: {"ka", "kd", "map_kd"}}."""
    mats, cur = {}, None
    for line in path.read_text().splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "newmtl":
            cur = mats.setdefault(parts[1], {"ka": (0.0, 0.0, 0.0),
                                             "kd": (0.8, 0.8, 0.8),
                                             "map_kd": ""})
        elif cur is not None and parts[0] in ("Ka", "Kd"):
            cur[parts[0].lower()] = tuple(float(x) for x in parts[1:4])
        elif cur is not None and parts[0] == "map_Kd":
            cur["map_kd"] = parts[-1]
    return mats


def read_obj(path) -> dict:
    """{"pos": [T, 3, 3], "uv": [T, 3, 2], "mat": [T] material names (None
    without one), "mtl": read_mtl's dict, "dir": the .obj's directory}."""
    path = Path(path)
    verts, uvs, faces, mtl, cur = [], [], [], {}, None
    for line in path.read_text().splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif tag == "vt":
            uvs.append([float(parts[1]),
                        float(parts[2]) if len(parts) > 2 else 0.0])
        elif tag == "f":
            corners = []
            for tok in parts[1:]:
                comp = tok.split("/")
                corners.append((int(comp[0]),
                                int(comp[1]) if len(comp) > 1 and comp[1]
                                else 0))
            faces.append((corners, cur))
        elif tag == "mtllib":
            mtl.update(read_mtl(path.parent / parts[1]))
        elif tag == "usemtl":
            cur = parts[1] if parts[1] in mtl else None

    def at(table, i):
        return table[i - 1 if i > 0 else len(table) + i]

    pos, tex, mat = [], [], []
    for corners, name in faces:
        for i in range(1, len(corners) - 1):
            tri = (corners[0], corners[i], corners[i + 1])
            pos.append([at(verts, v) for v, _ in tri])
            tex.append([at(uvs, t) if t and uvs else (0.0, 0.0)
                        for _, t in tri])
            mat.append(name)
    return {"pos": np.asarray(pos, np.float64).reshape(-1, 3, 3),
            "uv": np.asarray(tex, np.float64).reshape(-1, 3, 2),
            "mat": mat, "mtl": mtl, "dir": path.parent}


def read_png(path) -> np.ndarray:
    """An 8-bit RGB or RGBA, non-interlaced PNG -> [h, w, 3] uint8."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, head = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    w, h, depth, color, _, _, interlace = head
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit RGB / RGBA PNGs are read")
    ch = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w * ch + 1)
    out = np.zeros((h, w * ch), np.int64)
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        if f in (0, 2):  # none, up: no dependence along the row
            cur = (line + (prev if f == 2 else 0)) & 0xFF
            out[y], prev = cur, cur
            continue
        cur = np.zeros(w * ch, np.int64)
        for x in range(w * ch):
            a = cur[x - ch] if x >= ch else 0
            b = prev[x]
            c = prev[x - ch] if x >= ch else 0
            if f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[x] = (line[x] + pred) & 0xFF
        out[y], prev = cur, cur
    return out.reshape(h, w, ch)[..., :3].astype(np.uint8)
