"""What the benchmark makes from ``--seed`` and from a configuration: the
seed of each request, a training step's target image, and the input files
a configuration's meshes and image textures are read from."""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np
import torch

MASK64 = (1 << 64) - 1
WARM_UP = -1  # the request index of the warm-up call


def request_seed(seed: int, i: int) -> int:
    """The 32-bit sample seed of request ``i`` of a run seeded ``seed``
    (splitmix64 of the two), so no two requests of a run repeat and a run's
    requests do not depend on its length."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (i + 2) * 0xD1B54A32D192ED03) & MASK64
    for shift, mult in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        z = ((z ^ (z >> shift)) * mult) & MASK64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def target_image(seed: int, width: int, height: int, device) -> torch.Tensor:
    """A training step's target: [H*W, 3] float32 linear radiance, uniform
    in [0, 1), drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(request_seed(seed, -2))
    return torch.rand((width * height, 3), generator=gen, device=device,
                      dtype=torch.float32)


def encode_png(image_uint8: np.ndarray) -> bytes:
    """[h, w, 3] uint8 -> an 8-bit RGB PNG, every row unfiltered."""
    h, w, _ = image_uint8.shape
    raw = b"".join(b"\x00" + image_uint8[y].tobytes() for y in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_capsule(directory, segments=64, rings=45, texels=256) -> str:
    """Write a textured capsule as an .obj, its .mtl and a ``map_Kd`` PNG
    (a texels x texels checker, 8 squares a side) into ``directory`` and
    return the .obj's path.

    A closed surface around the origin along y: radius 0.5, a cylinder of
    length 1 and two hemispherical caps, ``segments`` quads around and
    ``rings`` quads from pole to pole, written as quad faces with texcoords
    (fan triangulation makes two triangles of each; at the poles one of
    them is degenerate and never hit).  64 x 45 gives 5,760 triangles."""
    cap = (rings - rings // 3) // 2  # quad rings per cap; the rest: cylinder
    cyl = rings - 2 * cap
    prof = [(-0.5 + 0.5 * math.sin(a), 0.5 * math.cos(a)) for a in
            (-math.pi / 2 + math.pi / 2 * k / cap for k in range(cap + 1))]
    prof += [(-0.5 + k / cyl, 0.5) for k in range(1, cyl + 1)]
    prof += [(0.5 + 0.5 * math.sin(a), 0.5 * math.cos(a)) for a in
             (math.pi / 2 * k / cap for k in range(1, cap + 1))]
    lines = ["mtllib capsule.mtl", "usemtl checker"]
    for r, (y, rho) in enumerate(prof):
        for s in range(segments + 1):
            a = 2.0 * math.pi * s / segments
            lines.append(f"v {rho * math.cos(a):.7f} {y:.7f} "
                         f"{rho * math.sin(a):.7f}")
            lines.append(f"vt {s / segments:.7f} {r / rings:.7f}")
    row = segments + 1
    for r in range(rings):
        for s in range(segments):
            q = (r * row + s + 1, r * row + s + 2, (r + 1) * row + s + 2,
                 (r + 1) * row + s + 1)
            lines.append("f " + " ".join(f"{i}/{i}" for i in q))
    base = os.path.join(directory, f"capsule_{segments}x{rings}")
    with open(base + ".obj", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(directory, "capsule.mtl"), "w") as f:
        f.write("newmtl checker\nKa 0 0 0\nKd 0.8 0.8 0.8\n"
                "map_Kd checker.png\n")
    ij = np.add.outer(np.arange(texels), np.arange(texels)) // (texels // 8)
    img = np.where((ij % 2)[..., None] == 0, (230, 200, 40), (40, 60, 200))
    with open(os.path.join(directory, "checker.png"), "wb") as f:
        f.write(encode_png(img.astype(np.uint8)))
    return base + ".obj"


def write_earthmap(directory, width=1024, height=512) -> str:
    """Write a ``width`` x ``height`` RGB PNG that stands in for the book's
    earthmap (1,024 x 512) into ``directory`` and return its path.

    Red climbs with the column and green with the row, and blue is a
    checker of 64-texel squares, so a flipped or swapped axis of the
    texture lookup shows at the size of the globe; each channel adds a hash
    of the texel's index (up to 30 levels), so a lookup one texel off shows
    too."""
    i = np.arange(width, dtype=np.int64)[None, :]
    j = np.arange(height, dtype=np.int64)[:, None]
    h = ((i * 73856093) ^ (j * 19349663)) & 0xFFFF
    img = np.stack(np.broadcast_arrays(
        20 + 200 * i // (width - 1) + h % 31,
        20 + 200 * j // (height - 1) + (h >> 5) % 31,
        60 + 120 * ((i // 64 + j // 64) % 2) + (h >> 10) % 31), axis=-1)
    path = os.path.join(directory, f"earthmap_{width}x{height}.png")
    with open(path, "wb") as f:
        f.write(encode_png(img.astype(np.uint8)))
    return path


MESHES = {"capsule": write_capsule}
IMAGES = {"earthmap": write_earthmap}


def write_inputs(config: dict, directory) -> list:
    """The input files of ``config``, written by their generators into
    ``directory`` (one sub-directory a file): the PNG of each ``image``
    texture, in the order ``textures`` lists them, then the .obj of each
    ``obj_mesh`` primitive."""
    entries = ([(IMAGES, t) for t in config.get("textures", [])
                if t["kind"] == "image"]
               + [(MESHES, p) for p in config["primitives"]
                  if p["kind"] == "obj_mesh"])
    paths = []
    for k, (makers, entry) in enumerate(entries):
        sub = os.path.join(directory, f"input{k}")
        os.makedirs(sub, exist_ok=True)
        args = {a: v for a, v in entry.items()
                if a not in ("name", "kind", "generator")}
        paths.append(makers[entry["generator"]](sub, **args))
    return paths
