"""The port's host library (``utils/native.py``: ``csrc/host/jpegdec.cpp``
and ``csrc/host/objparser.cpp``, built with the host C++ compiler) against
the JAX package's native library and pure-Python parser, and PIL.

JPEG bars: equal to JAX's ``native.decode_jpeg`` bit for bit, and within
tests/test_native_jpeg.py:34-37's bar of PIL's decode (max |diff| <= 4,
mean < 0.1).  The decoder replicates subsampled chroma (JAX's decoder
does); PIL, like the reference's stb_image, interpolates it.  So the bar
images keep their chroma constant (a textured grey under a fixed tint) and
the bar checks the entropy decode, the IDCT and the colour conversion;
``test_subsampled_chroma_is_replicated`` asserts how far the two
upsamplings part on a sharp colour edge.
"""

import builtins
import os
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models import mesh as jmesh
from another_raytracer_tpu.utils import assets as jassets
from another_raytracer_tpu.utils import native as jnative
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import mesh as tmesh
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.utils import assets, imageio, native

torch.set_num_threads(1)

SAMPLES = Path(native.__file__).resolve().parent / "jpeg_samples"
# name -> (PIL save options, PIL mode)
KINDS = {
    "baseline_420": (dict(quality=90, subsampling=2), "RGB"),
    "baseline_444": (dict(quality=90, subsampling=0), "RGB"),
    "progressive": (dict(quality=90, progressive=True), "RGB"),
    "gray": (dict(quality=90), "L"),
}


def tinted_texture(h, w, seed):
    """A textured grey under a fixed tint: every pixel is g + (24, 0, -24)
    with g in [40, 210], so Cb and Cr are constant."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    g = 0.5 + 0.18 * np.sin(2 * np.pi * (3 * x + 2 * y)) \
        + 0.12 * np.sin(2 * np.pi * (7 * x - 5 * y) + 1.0)
    g = 125 + 170 * (g - 0.5) + rng.uniform(-20, 20, (h, w))
    g = np.clip(g, 40, 210)
    return (g[..., None] + np.array([24.0, 0.0, -24.0])).round().astype(np.uint8)


def chroma_texture(h, w, seed):
    """Smooth colour waves with noise: Cb and Cr vary across the image, so a
    fault in the 4:2:0 chroma path shows in the decode."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    waves = [np.sin(2 * np.pi * (fx * x + fy * y) + ph)
             for fx, fy, ph in ((2, 1, 0.0), (-1, 3, 2.0), (3, -2, 4.0))]
    img = 128 + 80 * np.stack(waves, -1) + rng.uniform(-12, 12, (h, w, 3))
    return np.clip(img, 0, 255).round().astype(np.uint8)


# sample name -> (kind of KINDS, texture)
SAMPLE_KINDS = {"baseline_420": ("baseline_420", tinted_texture),
                "progressive": ("progressive", tinted_texture),
                "chroma_420": ("baseline_420", chroma_texture),
                "chroma_progressive": ("progressive", chroma_texture)}


def make_jpeg_samples(directory, names=tuple(SAMPLE_KINDS)):
    """The JPEG samples of the chip's ``jpeg`` phase (kept in
    ``utils/jpeg_samples``): a 128x64 texture saved as a JPEG of its kind,
    the JAX package's native decode of it as ``<name>.native.png`` and, for
    the tinted textures, PIL's decode as ``<name>.png``."""
    os.makedirs(directory, exist_ok=True)
    for name in names:
        kind, texture = SAMPLE_KINDS[name]
        opts, mode = KINDS[kind]
        path = os.path.join(directory, f"{name}.jpg")
        Image.fromarray(texture(64, 128, 0)).convert(mode).save(path, **opts)
        imageio.save_png(os.path.join(directory, f"{name}.native.png"),
                         jnative.decode_jpeg(path))
        if texture is tinted_texture:
            with Image.open(path) as im:
                imageio.save_png(os.path.join(directory, f"{name}.png"),
                                 np.asarray(im.convert("RGB")))


def pil_decode(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def within_pil_bar(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    return d.max() <= 4 and d.mean() < 0.1


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jpeg_matches_jax_native_and_pil(tmp_path, kind):
    opts, mode = KINDS[kind]
    path = tmp_path / f"{kind}.jpg"
    Image.fromarray(tinted_texture(37, 53, 1)).convert(mode).save(path, **opts)
    got = native.decode_jpeg(path)
    assert got.shape == (37, 53, 3) and got.dtype == np.uint8
    assert jnative.available()
    np.testing.assert_array_equal(got, jnative.decode_jpeg(path))
    assert within_pil_bar(got, pil_decode(path))
    np.testing.assert_array_equal(imageio.load_image(path), got / 255.0)


def test_subsampled_chroma_is_replicated(tmp_path):
    """A sharp red/green edge: at 4:4:4 the decode is within PIL's bar; at
    4:2:0 the replicated chroma parts from PIL's interpolated chroma by
    tens of levels on the edge, in the port and in JAX's decoder alike."""
    img = np.zeros((16, 32, 3), np.uint8)
    img[:, :15] = (220, 40, 40)
    img[:, 15:] = (40, 200, 60)
    diffs = {}
    for kind in ("baseline_444", "baseline_420"):
        path = tmp_path / f"{kind}.jpg"
        Image.fromarray(img).save(path, **KINDS[kind][0])
        got = native.decode_jpeg(path)
        np.testing.assert_array_equal(got, jnative.decode_jpeg(path))
        diffs[kind] = np.abs(got.astype(int) - pil_decode(path).astype(int))
    assert diffs["baseline_444"].max() <= 4
    assert diffs["baseline_420"].max() > 20
    # Away from the edge's two chroma columns the two agree.
    far = np.r_[0:12, 18:32]
    assert diffs["baseline_420"][:, far].max() <= 4


def test_committed_samples_are_pils_decodes(tmp_path):
    """The chip's samples (``make_jpeg_samples``) hold the JAX package's
    native decode of each JPEG, which the port's decode equals, and PIL's
    decode of the tinted ones, which it is within the bar of.  The chroma
    samples' Cb and Cr vary."""
    for name, (_, texture) in SAMPLE_KINDS.items():
        jpg = SAMPLES / f"{name}.jpg"
        nat = SAMPLES / f"{name}.native.png"
        assert jpg.stat().st_size < 8192 and nat.stat().st_size < 32768
        got = native.decode_jpeg(jpg)
        np.testing.assert_array_equal(imageio.load_png(nat),
                                      jnative.decode_jpeg(jpg))
        np.testing.assert_array_equal(got, imageio.load_png(nat))
        png = SAMPLES / f"{name}.png"
        assert png.exists() == (texture is tinted_texture)
        if texture is tinted_texture:
            assert png.stat().st_size < 32768
            np.testing.assert_array_equal(imageio.load_png(png),
                                          pil_decode(jpg))
            assert within_pil_bar(got, imageio.load_png(png))
        else:
            rgb = got.astype(float)
            cb = -0.1687 * rgb[..., 0] - 0.3313 * rgb[..., 1] + 0.5 * rgb[..., 2]
            cr = 0.5 * rgb[..., 0] - 0.4187 * rgb[..., 1] - 0.0813 * rgb[..., 2]
            assert cb.std() > 20 and cr.std() > 20
    # SOF0 in the baseline samples, SOF2 in the progressive ones.
    for name, (kind, _) in SAMPLE_KINDS.items():
        data = (SAMPLES / f"{name}.jpg").read_bytes()
        assert data[:2] == b"\xff\xd8"
        assert (b"\xff\xc2" if kind == "progressive" else b"\xff\xc0") in data


def test_undecodable_files_raise(tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="cannot decode"):
        native.decode_jpeg(bad)
    with pytest.raises(ValueError, match="cannot decode"):
        imageio.load_image(bad)
    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(16))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        imageio.load_image(tmp_path / "x.gif")
    with pytest.raises(ValueError, match="cannot read"):
        native.parse_obj(tmp_path / "missing.obj")
    (tmp_path / "far.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 4\n")
    with pytest.raises(ValueError, match="cannot read"):
        native.parse_obj(tmp_path / "far.obj")
    with pytest.raises(IndexError):
        tmesh.parse(tmp_path / "far.obj", native=False)


TINY_OBJ = """\
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
    f 2/2/1 3/3/1 5/1/1
    usemtl nothing
    f 3//1 4//1 5 1 2
"""


@pytest.fixture()
def tiny_obj(tmp_path):
    """tests/test_torch_mesh.py's tiny mesh (with normal indices added):
    negative v/vt indices, quads and pentagons, three materials."""
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
    (tmp_path / "m.obj").write_text(textwrap.dedent(TINY_OBJ))
    return tmp_path / "m.obj"


def _same_mesh(got, want):
    assert got.num_triangles == want.num_triangles
    np.testing.assert_array_equal(got.tri_pos, want.tri_pos)
    np.testing.assert_array_equal(got.tri_uv, want.tri_uv)
    np.testing.assert_array_equal(got.tri_mat, want.tri_mat)
    assert [(m.name, m.ka, m.kd, m.map_kd) for m in got.materials] == \
        [(m.name, m.ka, m.kd, m.map_kd) for m in want.materials]


def test_native_parser_matches_python(tiny_obj, tmp_path):
    got = tmesh.parse(tiny_obj)
    _same_mesh(got, tmesh.parse(tiny_obj, native=False))
    want = jmesh.MeshData(*jmesh._parse_obj_python(tiny_obj),
                          work_dir=tiny_obj.parent)
    _same_mesh(got, want)
    assert got.num_triangles == 10
    # The JAX package's native parser reads the corner "-5/-4" as two
    # vertices (native/objparser.cpp:130 takes a texcoord index only after
    # a digit), so it gives more triangles; the port's copy does not.
    assert jnative.parse_obj(tiny_obj)[0].shape[0] == 13
    # A generated mesh: chip_smoke's capsule with a PNG map.
    os.makedirs(tmp_path / "capsule")
    obj = chip_smoke.write_capsule(str(tmp_path / "capsule"), segments=16,
                                   rings=9, texels=16)
    _same_mesh(tmesh.parse(obj), tmesh.parse(obj, native=False))
    _same_mesh(tmesh.parse(obj), jmesh.MeshData(
        *jmesh._parse_obj_python(Path(obj)), work_dir=Path(obj).parent))


def _native_parse_in_child(path):
    """The native parser on ``path`` in a child process held to 1 GiB of
    address space and 60 s, so a parse that loops fails instead of hanging.
    Returns the child's exit code and its last line."""
    import subprocess

    code = ("import resource, sys\n"
            "resource.setrlimit(resource.RLIMIT_AS, (1 << 30, 1 << 30))\n"
            "from another_raytracer_tpu_torch.utils import native\n"
            "try:\n"
            "    print(native.parse_obj(sys.argv[1])[0].shape[0])\n"
            "except ValueError as e:\n"
            "    print('ValueError', e)\n")
    root = Path(__file__).resolve().parents[1]
    native.build()  # compile here, under no limit
    r = subprocess.run([sys.executable, "-c", code, str(path)], cwd=root,
                       capture_output=True, text=True, timeout=60)
    return r.returncode, (r.stdout.strip().splitlines() or [""])[-1]


@pytest.mark.parametrize("face", ["f 1 2 3 x", "f 1.0 2.0 3.0", "f 1/x 2 3",
                                  "f 1 2 3#", "f 1/2x 2 3", "f 1 - 3"])
def test_non_numeric_face_tokens_raise(tmp_path, face):
    """A face corner that is not an index fails both parsers (the Python
    parser's int() raises) and does not hang the native one."""
    obj = tmp_path / "bad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\n"
                   f"{face}\n")
    rc, last = _native_parse_in_child(obj)
    assert rc == 0 and last.startswith("ValueError") and "cannot read" in last
    with pytest.raises(ValueError):
        tmesh.parse(obj, native=False)


def test_face_token_forms_match_python(tmp_path):
    """Signed texcoord indices, empty texcoord slots and unread normal
    slots parse as the Python parser reads them."""
    obj = tmp_path / "forms.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                   "vt 0 0\nvt 1 0\nvt 0 1\n"
                   "f 1/+2/n 2//9 3/\nf 2/-1/x/y 4/1 3/-3\n")
    rc, last = _native_parse_in_child(obj)
    assert (rc, last) == (0, "2")
    _same_mesh(tmesh.parse(obj), tmesh.parse(obj, native=False))


def test_mesh_with_a_jpeg_map(tmp_path):
    """A mesh whose map_Kd is a JPEG: the atlas holds the decoded texels, as
    the JAX builder's (its native decoder) on the same file."""
    make_jpeg_samples(str(tmp_path), names=("baseline_420",))
    (tmp_path / "j.mtl").write_text("newmtl t\nmap_Kd baseline_420.jpg\n")
    (tmp_path / "j.obj").write_text(
        "mtllib j.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
        "usemtl t\nf 1/1 2/2 3/3\n")
    port, _ = tlib.mesh_scene(obj_path=tmp_path / "j.obj", device="cpu")
    texels = native.decode_jpeg(tmp_path / "baseline_420.jpg")
    assert port.img_w.tolist() == [128] and port.img_h.tolist() == [64]
    with _no_pil():
        ref, _ = jlib.mesh_scene(obj_path=tmp_path / "j.obj")
    _same_fields(port, ref)
    assert np.asarray(ref.atlas).size >= texels.size


class _no_pil:
    """Block PIL so the JAX package's ``load_image`` takes its native
    decoder (tests/test_native_jpeg.py:43-55)."""

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        real = builtins.__import__

        def no_pil(name, *a, **kw):
            if name == "PIL" or name.startswith("PIL."):
                raise ImportError("PIL blocked")
            return real(name, *a, **kw)

        self.mp.setattr(builtins, "__import__", no_pil)
        self.mp.delitem(sys.modules, "PIL", raising=False)
        self.mp.delitem(sys.modules, "PIL.Image", raising=False)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def _same_fields(port, ref):
    for name, value in port.tensors().items():
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in tscene.STATIC_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("builder", ["earth", "final_scene"])
def test_earthmap_jpeg_under_assets(tmp_path, monkeypatch, builder):
    """Scenes 4 and 8 take a found earthmap JPEG, field for field as the
    JAX builders do from the same file."""
    make_jpeg_samples(str(tmp_path), names=("chroma_420",))
    os.makedirs(tmp_path / "textures")
    os.replace(tmp_path / "chroma_420.jpg",
               tmp_path / "textures" / "earthmap.jpg")
    monkeypatch.setenv("ARTPU_ASSETS", str(tmp_path))
    # The JAX package reads ARTPU_ASSETS when it is imported.
    monkeypatch.setattr(jassets, "_CANDIDATES", (str(tmp_path),))
    assert assets.earthmap_path() == jassets.earthmap_path()
    port, params = getattr(tlib, builder)(device="cpu")
    with _no_pil():
        ref, rparams = getattr(jlib, builder)()
    assert params == rparams
    _same_fields(port, ref)
    assert 128 in port.img_w.tolist()  # not the 1x1 cyan fallback
