"""Port vs JAX: .obj meshes (``models/mesh.py``), image loading
(``utils/imageio.load_image``), the mesh scene (9) and ``--obj``, the
triangle geometry gradients, and the adaptive mode on a mesh in a medium.

The adaptive mode's JAX side runs without FMA in a child process
(``test_torch_media.jax_reference``): its masks come from integer corner
colours, which must be equal.
"""

import functools
import os
import struct
import textwrap
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from another_raytracer_tpu.grad import diff as jdiff
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models import mesh as jmesh
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import intersect as jix
from another_raytracer_tpu.ops import vec3 as jv
from another_raytracer_tpu.utils import imageio as jimageio
from another_raytracer_tpu_torch import cli
from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import mesh as tmesh
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import adaptive as tadaptive
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import intersect as tix
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tv
from another_raytracer_tpu_torch.utils import assets
from another_raytracer_tpu_torch.utils import imageio
from test_torch_bvh import _sheet
from test_torch_media import jax_reference

torch.set_num_threads(1)

W, H = 24, 18


def _png(path, img, filters, color_type=2):
    """Write an 8-bit PNG of ``img`` ([h, w, c] uint8) with the given
    filter type per row (0-4), as an encoder that filters would."""
    h, w, c = img.shape
    rows, prev = [], np.zeros(w * c, np.int64)
    for r in range(h):
        line = img[r].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        f = filters[r % len(filters)]
        if f == 0:
            pred = np.zeros_like(line)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = line

    def chunk(typ, data):
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.fixture()
def tiny_obj(tmp_path):
    """Every path of the loader: triangles and quads, negative indices,
    faces without a material (random colours), a flat mtl material, a
    textured one with a PNG map and one whose map is missing (cyan)."""
    rng = np.random.default_rng(3)
    _png(tmp_path / "grid.png", rng.integers(0, 256, (5, 7, 3), np.uint8),
         [0, 1, 2, 3, 4])
    (tmp_path / "m.mtl").write_text(textwrap.dedent("""\
        newmtl red
        Ka 0.1 0.0 0.0
        Kd 0.7 0.1 0.1
        newmtl tex
        Ka 0 0 0
        Kd 1 1 1
        map_Kd grid.png
        newmtl lost
        map_Kd nowhere.png
    """))
    (tmp_path / "m.obj").write_text(textwrap.dedent("""\
        # a test mesh
        mtllib m.mtl
        v 0 0 0
        v 1 0 0
        v 1 1 0
        v 0 1 0
        v 0.5 0.5 1
        vt 0 0
        vt 1 0
        vt 1 1
        vt 0 1
        f 1 2 5
        f -5 -3 -1
        usemtl red
        f 1/1 2/2 3/3
        usemtl tex
        f 1/1 2/2 3/3 4/4
        f -5/-4 -2/-1 -1/-2
        usemtl lost
        f 2/2 3/3 5/1
        usemtl nothing
        f 3 4 5 1 2
    """))
    return tmp_path / "m.obj"


def test_parse_and_builder_match_jax(tiny_obj):
    """The port's ``parse`` (its native parser) against the JAX package's
    pure-Python parser: JAX's ``parse`` takes its native parser where that
    is built, which reads a corner ``-5/-4`` as more than one vertex
    (tests/test_torch_native.py)."""
    got = tmesh.parse(tiny_obj)
    want = jmesh.MeshData(*jmesh._parse_obj_python(tiny_obj),
                          work_dir=tiny_obj.parent)
    assert got.num_triangles == want.num_triangles == 10
    np.testing.assert_array_equal(got.tri_pos, want.tri_pos)
    np.testing.assert_array_equal(got.tri_uv, want.tri_uv)
    np.testing.assert_array_equal(got.tri_mat, want.tri_mat)
    assert [(m.name, m.ka, m.kd, m.map_kd) for m in got.materials] == \
           [(m.name, m.ka, m.kd, m.map_kd) for m in want.materials]
    assert got.tri_mat.tolist() == [-1, -1, 0, 1, 1, 1, 2, -1, -1, -1]
    tb, jb = tscene.SceneBuilder(seed=5), JBuilder(seed=5)
    assert tmesh.add_to_builder(tb, got) == jmesh.add_to_builder(jb, want) == 10
    port, ref = tb.build(device="cpu"), jb.build()
    for name, value in port.tensors().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in tscene.STATIC_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    # The PNG map and the missing one's cyan fallback are in the atlas.
    assert port.img_w.tolist() == [7, 1] and port.img_h.tolist() == [5, 1]
    with pytest.raises(FileNotFoundError):
        tmesh.parse(tiny_obj.parent / "nope.obj")


@pytest.mark.parametrize("color_type,filters", [(2, [0]), (2, [1, 2, 3, 4]),
                                                (6, [4, 3, 2, 1, 0]),
                                                (0, [2, 4]), (4, [3, 1])])
def test_load_image_matches_jax(tmp_path, color_type, filters):
    chans = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    img = np.random.default_rng(color_type).integers(0, 256, (9, 11, chans),
                                                      np.uint8)
    path = tmp_path / "x.png"
    _png(path, img, filters, color_type)
    got = imageio.load_image(path)
    want = jimageio.load_image(path)
    assert got.shape == (9, 11, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    rgb = np.repeat(img[..., :1], 3, -1) if chans <= 2 else img[..., :3]
    np.testing.assert_array_equal(imageio.load_png(path), rgb)


def test_load_image_refuses_what_it_cannot_decode(tmp_path):
    """A missing file is the cyan fallback; a file that exists and cannot be
    decoded raises instead of rendering cyan, in a mesh's map and as the
    earthmap (scenes 4 and 8) alike."""
    assert imageio.load_image(tmp_path / "missing.png") is None
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="JPEG"):
        imageio.load_image(tmp_path / "x.jpg")
    (tmp_path / "j.mtl").write_text("newmtl t\nmap_Kd x.jpg\n")
    (tmp_path / "j.obj").write_text("mtllib j.mtl\nv 0 0 0\nv 1 0 0\n"
                                    "v 0 1 0\nusemtl t\nf 1 2 3\n")
    with pytest.raises(ValueError, match="JPEG"):
        tlib.mesh_scene(obj_path=tmp_path / "j.obj", device="cpu")
    os.makedirs(tmp_path / "textures")
    (tmp_path / "textures" / "earthmap.jpg").write_bytes(b"\xff\xd8")
    mp = pytest.MonkeyPatch()
    mp.setenv("ARTPU_ASSETS", str(tmp_path))
    try:
        assert assets.earthmap_path() is not None
        with pytest.raises(ValueError, match="JPEG"):
            tlib.final_scene(device="cpu")
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def capsule(tmp_path_factory):
    return chip_smoke.write_capsule(str(tmp_path_factory.mktemp("mesh")),
                                    segments=16, rings=9, texels=16)


def test_mesh_scene_fields_match_jax(capsule, monkeypatch):
    port, params = tlib.mesh_scene(obj_path=capsule, device="cpu")
    ref, rparams = jlib.mesh_scene(obj_path=capsule)
    assert params == rparams and params["lookfrom"] == (2, 2, 1)
    for name, value in port.tensors().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in tscene.STATIC_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.n_triangles == 288 and port.tri_in_bvh and port.n_media == 1
    carried = tscene.scene_from_reference(ref, device="cpu")
    for name, value in carried.tensors().items():
        assert torch.equal(value, port.tensors()[name]), name
    # No mesh given and no asset: FileNotFoundError, as in the JAX package.
    monkeypatch.delenv("ARTPU_ASSETS", raising=False)
    assert assets.capsule_obj_path() is None
    with pytest.raises(FileNotFoundError):
        tlib.build(9, device="cpu")
    for path in (assets.cow_obj_path(), assets.dino_obj_path()):
        assert path is None


@pytest.mark.parametrize("leaf", ["tri_v0", "tri_v1", "tri_v2"])
def test_triangle_record_gradients_match_jax(leaf):
    """tri_v* through the winner recompute on the 128-triangle sheet (in a
    BVH), against jax.grad."""
    ref = _sheet(JBuilder)[0].build(bvh=True)
    port = tscene.scene_from_reference(ref, device="cpu")
    assert port.tri_in_bvh
    n = 512
    rng = np.random.default_rng(9)
    # Rays from above the sheet toward points around it.
    o = rng.uniform((-1.5, 0.8, -4.5), (1.5, 2.0, -1.5), (n, 3))
    d = rng.uniform((-1.2, -0.2, -4.2), (1.2, 0.2, -1.8), (n, 3)) - o
    o, d = o.T.astype(np.float32), d.T.astype(np.float32)
    t = np.zeros(n, np.float32)
    w = rng.uniform(0.2, 1.0, (10, n)).astype(np.float32)
    um = np.zeros((n, 0), np.float32)
    jo, jd = jv.V3(*map(jnp.asarray, o)), jv.V3(*map(jnp.asarray, d))
    jt, jk, ji = jix.closest_hit(ref, jo, jd, jnp.asarray(t), jnp.asarray(um),
                                 1e-3)

    def jloss(x):
        rec = jix.make_hit_record(ref.replace(**{leaf: x}), jo, jd,
                                  jnp.asarray(t), jt, jk, ji)
        parts = (*rec.p, *rec.normal, rec.t, rec.u, rec.v, rec.tu, rec.tv)
        return sum(jnp.sum(c * jnp.asarray(wc)) for c, wc in zip(parts, w))

    want = np.asarray(jax.grad(jloss)(getattr(ref, leaf)))
    to = tv.V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in o))
    td = tv.V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in d))
    with torch.no_grad():
        tt, tk, ti = tix.closest_hit(port, to, td, torch.from_numpy(t),
                                     torch.from_numpy(um), 1e-3)
    assert (tk == tscene.PRIM_TRIANGLE).sum() > 100
    x = getattr(port, leaf).clone().requires_grad_(True)
    rec = tix.make_hit_record(port.replace(**{leaf: x}), to, td,
                              torch.from_numpy(t), tt, tk, ti)
    parts = (*rec.p, *rec.normal, rec.t, rec.u, rec.v, rec.tu, rec.tv)
    loss = sum((c * torch.from_numpy(wc)).sum() for c, wc in zip(parts, w))
    (got,) = torch.autograd.grad(loss, [x])
    assert torch.isfinite(got).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def _bary_triangle(cls):
    """A big barycentric-textured triangle covering the view (the scene of
    tests/test_grad_geometry.py:55-65)."""
    b = cls(background=(0.1, 0.1, 0.1), seed=2)
    bary = b.barycentric_texture((1, 0, 0), (0, 1, 0), (0, 0, 1))
    b.triangle((-30, -30, -3), (30, -30, -3), (0, 40, -3),
               b.lambertian(texture=bary))
    return b.build(device="cpu") if cls is tscene.SceneBuilder else b.build()


@functools.lru_cache(maxsize=None)
def _bary_case():
    ref = _bary_triangle(JBuilder)
    params = dict(lookfrom=(0, 0, 2), lookat=(0, 0, -3), vfov=50.0)
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    target = np.random.default_rng(2).uniform(0, 0.5, (W * H, 3)).astype(np.float32)
    kw = dict(width=W, height=H, spp=2, samples_per_pass=1, max_depth=4,
              t_min=1e-3)
    leaves = {k: getattr(ref, k) for k in ("tri_v0", "tri_v2")}
    loss, grads = jax.value_and_grad(jdiff.render_loss)(
        leaves, ref, ref_cam, jnp.asarray(target), jnp.uint32(5), **kw)
    return params, target, kw, float(loss), {k: np.asarray(g)
                                             for k, g in grads.items()}


def test_whole_trace_triangle_gradients_match_jax():
    params, target, kw, loss_w, grads_w = _bary_case()
    port = _bary_triangle(tscene.SceneBuilder)
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    leaves = {k: getattr(port, k) for k in grads_w}
    loss_g, grads_g = diff.render_value_and_grad(
        leaves, port, cam, torch.from_numpy(target), 5, **kw)
    np.testing.assert_allclose(float(loss_g), loss_w, rtol=1e-5)
    for k, want in grads_w.items():
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(grads_g[k].numpy(), want, rtol=2e-4,
                                   atol=2e-4 * scale, err_msg=k)


@pytest.mark.parametrize("mode", ["adaptive", "single"])
def test_cli_renders_an_obj(capsule, tmp_path, capsys, mode):
    out = tmp_path / "mesh.png"
    argv = ["--scene", "9", "--obj", capsule, "--width", "24", "--height",
            "24", "--spp", "1", "--max-depth", "4", "--device", "cpu",
            "--out", str(out)]
    # adaptive is the default mode, as in the JAX CLI.
    rc = cli.main(argv + (["--mode", mode] if mode == "single" else []))
    assert rc == 0
    img = imageio.load_png(out)
    assert img.shape == (24, 24, 3) and img.mean() > 10
    printed = capsys.readouterr().out
    assert f"mode={mode}" in printed and "segments" in printed


def test_cli_defaults_need_the_mesh_asset(tmp_path, monkeypatch):
    """``--scene 9 --mode adaptive`` are the defaults; without ``--obj`` and
    with no asset the mesh scene raises, as in the JAX CLI."""
    monkeypatch.delenv("ARTPU_ASSETS", raising=False)
    with pytest.raises(FileNotFoundError):
        cli.main(["--device", "cpu", "--out", str(tmp_path / "x.png")])
    with pytest.raises(FileNotFoundError):
        cli.main(["--obj", str(tmp_path / "nope.obj"), "--device", "cpu",
                  "--out", str(tmp_path / "x.png")])
    assert not os.path.exists(tmp_path / "x.png")


AW, AH, ASPP, ADEPTH = 48, 36, 2, 5


@pytest.fixture(scope="module")
def jax_adaptive(capsule):
    return jax_reference(f"""
from another_raytracer_tpu.config import RenderConfig, RenderMode
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.ops import adaptive, camera as jcam
from another_raytracer_tpu.ops import render as jrender
masks = []
orig = adaptive._heuristic
adaptive._heuristic = lambda *a, **k: masks.append(np.asarray(orig(*a, **k))) or masks[-1]
sc, p = jlib.mesh_scene(obj_path=obj)
cam = jcam.make_camera(aspect_ratio={AW} / {AH}, **p)
img, stats = jrender.render(sc, cam, RenderConfig(
    width={AW}, height={AH}, samples_per_pixel={ASPP}, max_depth={ADEPTH},
    seed=2, mode=RenderMode.ADAPTIVE))
out["image"] = np.asarray(img)
out["traced"] = stats["traced_pixels"]
for i, m in enumerate(masks):
    out[f"mask{{i}}"] = m
""", obj=capsule)


def test_adaptive_matches_jax(capsule, jax_adaptive, monkeypatch):
    scene, params = tlib.mesh_scene(obj_path=capsule, device="cpu")
    cam = tcam.make_camera(aspect_ratio=AW / AH, device="cpu", **params)
    masks = []
    orig = tadaptive._heuristic
    monkeypatch.setattr(tadaptive, "_heuristic", lambda *a, **k: masks.append(
        np.asarray(orig(*a, **k))) or masks[-1])
    img, stats = trender.render(scene, cam, RenderConfig(
        width=AW, height=AH, samples_per_pixel=ASPP, max_depth=ADEPTH, seed=2,
        mode=RenderMode.ADAPTIVE))
    assert len(masks) == 3
    for i, m in enumerate(masks):
        np.testing.assert_array_equal(m, jax_adaptive[f"mask{i}"])
    assert masks[0].any() and not masks[0].all()
    assert stats["traced_pixels"] == int(jax_adaptive["traced"])
    close = np.abs(img.astype(int) - jax_adaptive["image"].astype(int)) <= 2
    assert close.all(axis=-1).mean() >= 0.98
