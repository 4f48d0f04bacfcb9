"""Port vs JAX: ``bench_extra.py``, the counterpart of
``scripts/bench_extra.py``, and ``trace_scene.py``.

The three scene factories leaf by leaf and ``CONFIGS`` row by row; then
every forward and adaptive row at a tiny size through the port's runner
and through the JAX script's (``run_forward``, ``run_adaptive``), the mesh
rows on a small capsule that ``chip_smoke.write_capsule`` writes into a
temporary directory (``test_torch_bench_extra_grad.py`` holds the gradient
rows).  Forward rows are held to the segment and radiance bar of
tests/test_mega.py:37-45; the adaptive row's traced pixels and image must
be equal.  The port's megakernel takes sphere hits as ``o + t d`` there, as
the JAX side does (``megakernel_like_jax``, tests/jax_sphere_record.py).  The JAX side runs in one child process whose XLA:CPU emits no
FMA (``test_torch_media.jax_reference``); the script is imported with its
persistent compilation cache in the test's temporary directory, so the
raw outputs, computed by the same calls as the runners', reuse the
runners' compiled programs.  Then the skip line of a row whose input is
absent, ``main --cpu`` in-process, and ``trace_scene`` on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from another_raytracer_tpu_torch import bench_extra, trace_scene
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from test_torch_media import forward_bar, jax_reference
from test_torch_scene import _assert_scene_equal
from jax_sphere_record import megakernel_like_jax  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (24, 12, 2, 3)  # W, H, spp, depth (12 | W, H for the adaptive row)
ROWS = [n for n, row in bench_extra.CONFIGS.items()
        if row[5] != "grad" and n != "mesh_hd"]

# The JAX side of every row in NAMES at SIZES[mode]: the script's runner
# for its record fields, then the row's raw output by the runner's call.
JAX_ROWS = """
import os, sys
os.environ["ART_COMPILE_CACHE"] = CACHE
sys.path.insert(0, "scripts")
import bench_extra as be
from another_raytracer_tpu.config import RenderConfig, RenderMode
from another_raytracer_tpu.grad import diff
from another_raytracer_tpu.models import library
from another_raytracer_tpu.ops import camera as camera_lib
from another_raytracer_tpu.ops import render as render_lib
from another_raytracer_tpu.ops import vec3 as jvec3
for name in NAMES.split(","):
    factory, *_, mode = be.CONFIGS[name]
    w, h, spp, depth = SIZES[mode]
    if factory is library.mesh_scene:
        scene, cp = library.mesh_scene(obj_path=OBJ)
    else:
        scene, cp = factory()
    cam = camera_lib.make_camera(aspect_ratio=w / h, **cp)
    runner = {"adaptive": be.run_adaptive,
              "grad": be.run_grad}.get(mode, be.run_forward)
    _, segs, _, extra = runner(scene, cam, w, h, spp, depth)
    out[name + "/segments"] = segs
    kw = dict(width=w, height=h, spp=spp, samples_per_pass=1,
              max_depth=depth, t_min=1e-3)
    if mode == "single":
        acc, _ = jax.jit(lambda s, c: render_lib.render_radiance(
            s, c, jnp.uint32(0), **kw))(scene, cam)
        out[name + "/radiance"] = jvec3.to_numpy(acc)
    elif mode == "adaptive":
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           max_depth=depth, mode=RenderMode.ADAPTIVE)
        out[name + "/image"], _ = render_lib.render(scene, cam, cfg)
        out[name + "/traced_pixels"] = extra["traced_pixels"]
    else:
        trainable = diff.DEFAULT_TRAINABLE + ("tri_v0", "tri_v1", "tri_v2")
        params, _ = diff.split_params(scene, trainable)
        target = jnp.zeros((w * h, 3), jnp.float32)
        loss, grads = jax.jit(lambda p, s, c, t: jax.value_and_grad(
            diff.render_loss)(p, s, c, t, jnp.uint32(0), **kw))(
            params, scene, cam, target)
        out[name + "/loss"] = float(loss)
        out[name + "/grad_norm"] = extra["grad_norm"]
        out[name + "/grad_leaves"] = extra["grad_leaves"]
"""


def jax_rows(names, sizes, tmp):
    """Run JAX_ROWS for ``names`` in a child without FMA; the mesh rows on
    a small capsule written into ``tmp``."""
    obj = chip_smoke.write_capsule(str(tmp), segments=8, rings=6, texels=16)
    (tmp / "cache").mkdir()
    want = jax_reference(f"SIZES = {sizes!r}\n" + JAX_ROWS,
                         NAMES=",".join(names), OBJ=obj,
                         CACHE=str(tmp / "cache"))
    return obj, want


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return jax_rows(ROWS, {"single": SIZE, "adaptive": SIZE},
                    tmp_path_factory.mktemp("bench_extra"))


@pytest.fixture
def jbe(monkeypatch):
    """The JAX script as a module, its persistent compilation cache off."""
    monkeypatch.setenv("ART_COMPILE_CACHE", "0")
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import bench_extra as script

    return script


def test_scene_factories_match_jax(jbe):
    for name in ("metal_diel_scene", "sphere_ground_scene", "textures_scene"):
        port, port_cam = getattr(bench_extra, name)(device="cpu")
        ref, ref_cam = getattr(jbe, name)()
        _assert_scene_equal(port, ref)
        assert port_cam == ref_cam, name


def test_configs_match_jax(jbe):
    assert list(bench_extra.CONFIGS) == list(jbe.CONFIGS)
    for name, (factory, *row) in bench_extra.CONFIGS.items():
        jfactory, *jrow = jbe.CONFIGS[name]
        assert row == jrow, name
        assert factory.__name__ == jfactory.__name__, name


@pytest.mark.parametrize("name", ROWS)
def test_row_matches_jax(jax_side, name, megakernel_like_jax):
    obj, want = jax_side
    wl = bench_extra.setup(name, "cpu", obj, SIZE)
    rec, run = bench_extra.measure(wl)
    assert rec["config"] == "24x12 spp2 depth3 " + wl.mode
    assert rec["backend"] == "cpu" and rec["card"] is None
    assert not any(v for k, v in rec["kernels"].items() if k != "K5_by_tree")
    if bench_extra.CONFIGS[name][0] in bench_extra.MESH_FACTORIES:
        assert rec["mesh"] == {"obj": "capsule_8x6", "triangles": 96}
    segs = int(want[name + "/segments"])
    if wl.mode == "single":
        forward_bar(tvec3.to_numpy(run.out[0]), want[name + "/radiance"],
                    rec["segments"], segs)
    else:
        assert rec["segments"] == segs
        assert rec["traced_pixels"] == int(want[name + "/traced_pixels"])
        assert rec["total_pixels"] == SIZE[0] * SIZE[1]
        np.testing.assert_array_equal(run.out[0], want[name + "/image"])


def test_absent_inputs_print_the_skip_line(monkeypatch, capsys):
    from another_raytracer_tpu.models import library as jlib

    monkeypatch.delenv("ARTPU_ASSETS", raising=False)
    with pytest.raises(FileNotFoundError) as e:
        jlib.mesh_scene()
    assert bench_extra.main(["mesh", "mesh_hd", "--cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        f"skip mesh: {e.value}", "skip mesh_hd: cow.obj not available"]


def test_main_on_the_cpu(monkeypatch, capsys, tmp_path):
    """Two rows at a tiny size: a record each, the file merged by row."""
    for name in ("cornell", "sphere_ground_grad"):
        row = bench_extra.CONFIGS[name]
        monkeypatch.setitem(bench_extra.CONFIGS, name,
                            (row[0], 24, 12, 2, 2, row[5]))
    out = tmp_path / "records.json"
    out.write_text(json.dumps([{"scene": "random", "ms": 1.0}]))
    assert bench_extra.main(["cornell", "sphere_ground_grad", "--cpu",
                             "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"wrote {out}"
    recs = [json.loads(ln) for ln in lines[:-1]]
    assert json.loads(out.read_text()) == [{"scene": "random", "ms": 1.0}] \
        + recs
    keys = {"scene", "config", "ms", "mrays_per_s", "segments", "compile_s",
            "backend", "card", "kernels", "peak_mem_mb"}
    assert [r["scene"] for r in recs] == ["cornell", "sphere_ground_grad"]
    assert set(recs[0]) == keys
    assert set(recs[1]) == keys | {"fwd_bwd", "grad_leaves", "grad_norm"}
    for r in recs:
        assert r["segments"] > 0 and r["ms"] > 0 and r["compile_s"] > 0
        assert r["mrays_per_s"] == pytest.approx(
            r["segments"] / r["ms"] / 1e3)
    assert recs[1]["grad_leaves"] == 10 and recs[1]["grad_norm"] > 0


def test_needs_a_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_extra.main(["cornell"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_scene.main(["cornell"])


def test_trace_scene_on_the_cpu(capsys):
    s = trace_scene.trace("final_grad_bench", "cpu", size=(24, 12, 2, 2))
    assert s["device"] == "cpu" and s["runs"] == trace_scene.RUNS
    assert sum(s["by_category"].values()) == pytest.approx(s["busy_ms"])
    assert 0 < s["busy_ms"] <= s["wall_ms"] and 0 < s["busy_share"] <= 1
    assert 0 < len(s["top"]) <= trace_scene.TOP
    assert sum(ms for _, ms, _ in s["top"]) <= s["busy_ms"] * (1 + 1e-9)
    trace_scene.report(s)
    text = capsys.readouterr().out
    assert "host operator time by category" in text
    assert "top individual ops" in text and "device time" not in text


def test_trace_scene_categories():
    """The card's kernel names by category, on events as the profiler
    writes them."""
    names = {
        "void mega_forward_kernel<0>(float const*, unsigned int const*)":
            "K1 / K2 (megakernel sweep)",
        "void mega_forward_kernel<2>(float const*)":
            "K3 / K3 record (megakernel walk)",
        "mega_replay_kernel(Args)": "replay",
        "void bvh_kernel<0, true, false, false, true>(Params, Rays, Out)":
            "K5 (BVH closest hit)",
        "perlin_kernel(float const*)": "K4 (Perlin noise)",
        "void at::native::reduce_kernel<512, 1>(ReduceOp)": "reduce",
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::AddFunctor<float>>(int)": "elementwise",
        "void at::native::elementwise_kernel<128, 4, "
        "direct_copy_kernel_cuda>(int)": "copies and fills",
        "void cub::DeviceRadixSortOnesweepKernel<...>()": "other",
    }
    events = [{"name": n, "cat": "kernel", "dur": 2.0, "tid": 7, "ts": i}
              for i, n in enumerate(names)]
    events.append({"name": "Memcpy DtoH", "cat": "gpu_memcpy", "dur": 4.0})
    for e, want in zip(events, list(names.values()) + ["copies and fills"]):
        assert trace_scene.category(e) == want, e["name"]
    s = trace_scene.summarize(events, runs=2, wall_s=1e-3)
    assert s["busy_ms"] == pytest.approx(0.011)
    assert s["by_category"]["copies and fills"] == pytest.approx(0.003)
    assert s["busy_share"] == pytest.approx(0.022)
    assert s["top"][0] == ("Memcpy DtoH", pytest.approx(0.002), 0.5)
