"""The kernels' tables packed once per scene (CPU, no card): K5's compact
16-byte BVH tables and their route by size, K3's tables as K5's sphere
tables, and K4's packed Perlin tables.

csrc/bvh_kernel.cu reads ``bvh_kernel.pack_tables``: per node two float4 of
node columns, per leaf row the float4s of ``TABLE_COLUMNS[prim, precomp]``.
Each compact float must be the wide row's float it stands for (the kernel is
bit-equal to the plain version, which walks the wide rows), every other slot
zero.  csrc/perlin_kernel.cu reads ``perlin_kernel.pack_tables``: ranvec as
float4 and each axis's perm entries at a lattice index and the next as one
16-bit word.
"""

import numpy as np
import pytest
import torch

from another_raytracer_tpu_torch.models import bvh as bvh_lib
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops.kernels import bvh_kernel as tbk
from another_raytracer_tpu_torch.ops.kernels import mega_kernel as tmk
from another_raytracer_tpu_torch.ops.kernels import perlin_kernel as tpk
from chip_smoke import sheet_scene

torch.set_num_threads(1)


def _tree(prim, n, rng, fold_cols=True):
    """(nodes, rows) of n random primitives of a kind, packed as the
    builder packs them (planar with texcoords: 35 columns)."""
    if prim == "planar":
        base = rng.uniform(-20, 20, (n, 3))
        v = [base] + [base + rng.uniform(-1, 1, (n, 3)) for _ in range(2)]
        uvs = [rng.uniform(0, 1, (n, 2)) for _ in range(3)]
        tree = bvh_lib.build(*bvh_lib.triangle_bounds(*v), leaf_size=16)
        return tbk.pack_planar(tree, *v, np.arange(n) * 4 + 2, uv0=uvs[0],
                               uv1=uvs[1], uv2=uvs[2],
                               mats=rng.integers(0, 8, n))
    if prim == "sphere":
        c0 = rng.uniform(-5, 5, (n, 3))
        c1 = c0 + rng.uniform(-0.3, 0.3, (n, 3))
        r, t0 = rng.uniform(0.2, 0.8, n), np.zeros(n)
        t1 = np.where(np.arange(n) % 3 == 0, 0.0, 1.0)  # some dt = 0
        tree = bvh_lib.build(*bvh_lib.sphere_bounds(c0, c1, r, t0, t1),
                             leaf_size=16)
        extra = (dict(mats=rng.integers(0, 5, n), has_uv=np.ones(n))
                 if fold_cols else {})
        return tbk.pack_spheres(tree, c0, c1, t0, t1, r, **extra)
    axis = rng.integers(0, 3, n)
    lo = rng.uniform(-8, 6, (n, 2))
    hi = lo + rng.uniform(0.5, 2.0, (n, 2))
    k = rng.uniform(-8, 8, n)
    tree = bvh_lib.build(*bvh_lib.rect_bounds(axis, k, lo, hi), leaf_size=16)
    return tbk.pack_rects(tree, axis, k, lo, hi, np.arange(n) * 4 + 1)


LAYOUTS = [("planar", False, True), ("planar", True, True),
           ("sphere", False, True), ("sphere", False, False),
           ("rect", False, True)]


@pytest.mark.parametrize("prim,precomp,fold_cols", LAYOUTS)
def test_packers_regroup_the_wide_rows(prim, precomp, fold_cols):
    nodes, rows = (torch.from_numpy(a) for a in
                   _tree(prim, 200, np.random.default_rng(3), fold_cols))
    tab = tbk.pack_tables(nodes, rows, prim, precomp)
    groups = tbk.TABLE_COLUMNS[prim, precomp]
    m, n = nodes.shape[0], rows.shape[0]
    assert tab.dtype == torch.float32 and tab.is_contiguous()
    assert tab.shape == (2 * m + len(groups) * n, 4)
    node4 = tab[:2 * m].reshape(m, 2, 4)
    row4 = tab[2 * m:].reshape(n, len(groups), 4)
    for k, group in enumerate(tbk.NODE_COLUMNS):
        for c, col in enumerate(group):
            assert torch.equal(node4[:, k, c], nodes[:, col])
    read = set()
    for k, group in enumerate(groups):
        for c, col in enumerate(group):
            if col is None:
                assert not row4[:, k, c].any()
            else:
                assert torch.equal(row4[:, k, c], rows[:, col]), (k, c, col)
                read.add(col)
    # Every column a leaf test reads (csrc/bvh_kernel.cu), pad rows
    # included; the winner's code and fold columns stay in the wide rows.
    want = {("planar", False): set(range(9)),
            ("planar", True): set(range(17, 33)),
            ("sphere", False): set(range(9)),
            ("rect", False): set(range(6))}[prim, precomp]
    assert read == want


def test_k3_tables_are_k5_sphere_tables_on_scene1():
    scene, _ = library.random_scene(device="cpu")
    tab = tmk.pack_accel_tables(scene)
    assert torch.equal(tab, scene.k5_tables("sphere"))
    # The floats K3 reads: every node column, and per sphere c0, r, c1 - c0,
    # t0 and 1/dt (the third float4's x), as the rows hold them.
    nodes, rows = scene.sph_bvh_nodes, scene.sph_bvh_rows
    m = nodes.shape[0]
    sph = tab[2 * m:].reshape(-1, 3, 4)
    assert torch.equal(tab[:2 * m].reshape(m, 8)[:, [0, 1, 2, 4, 5, 6, 3, 7]],
                       nodes)
    assert torch.equal(sph[:, 0], rows[:, [0, 1, 2, 8]])
    assert torch.equal(sph[:, 1], rows[:, [3, 4, 5, 6]])
    assert torch.equal(sph[:, 2, 0], rows[:, 7])


def test_route_by_table_size():
    scene1, _ = library.random_scene(device="cpu")
    tab1 = scene1.k5_tables("sphere")
    assert tab1.numel() * 4 == 45104 and tbk.table_route(tab1) == "shared"
    sheet, _ = sheet_scene("cpu")
    assert sheet.n_triangles == 128
    for pre in (False, True):
        assert tbk.table_route(sheet.k5_tables("planar", pre)) == "shared"
    rng = np.random.default_rng(0)
    rects = tbk.pack_tables(*map(torch.from_numpy, _tree("rect", 128, rng)),
                            "rect")
    assert tbk.table_route(rects) == "shared"
    soup = [torch.from_numpy(a) for a in _tree("planar", 10240, rng)]
    for pre in (False, True):
        tab = tbk.pack_tables(*soup, "planar", pre)
        assert tab.numel() * 4 > tbk.MAX_SMEM
        assert tbk.table_route(tab) == "global"


def test_scene_keeps_its_packed_tables():
    scene, _ = library.random_scene(device="cpu")
    tab = scene.k5_tables("sphere")
    assert scene.k5_tables("sphere") is tab
    # A copy with other shading leaves keeps the tables; one with other
    # rows packs its own.
    assert scene.replace(tex_ca=scene.tex_ca * 2).k5_tables("sphere") is tab
    moved = scene.replace(sph_bvh_rows=scene.sph_bvh_rows + 1.0)
    assert not torch.equal(moved.k5_tables("sphere"), tab)
    noise, _ = library.two_perlin_spheres(device="cpu")
    per = noise.perlin_tables()
    assert noise.replace(background=noise.background).perlin_tables() is per


def _noise_scene(q):
    b = SceneBuilder(seed=11)
    for k in range(q):
        b.sphere((0, 0, -k), 0.5, b.lambertian(texture=b.noise_texture(1.0 + k)))
    return b.build(device="cpu")


@pytest.mark.parametrize("q", [1, 3, 37])
def test_perlin_tables_unpack_to_perm_and_ranvec(q):
    scene = _noise_scene(q)
    tab = scene.perlin_tables()
    assert tab.shape == (q, tpk.TABLE_BYTES) and tab.dtype == torch.uint8
    assert q <= tpk.MAX_TABLES
    ran4 = tab[:, :4096].contiguous().view(torch.float32).reshape(q, 256, 4)
    assert torch.equal(ran4[..., :3], scene.per_ranvec)
    assert not ran4[..., 3].any()
    words = tab[:, 4096:].reshape(q, 3, 256, 2).to(torch.int32)
    assert torch.equal(words[..., 0], scene.per_perm)
    assert torch.equal(words[..., 1], torch.roll(scene.per_perm, -1, dims=-1))
