"""Port vs JAX: the inverse-rendering demos (``train_demo.py``), the
counterparts of ``scripts/train_demo.py`` and ``scripts/train_demo_atlas.py``.

Three adam steps of each protocol at the scripts' CPU configuration against
the same three steps through the JAX package (Cornell: its
``diff.make_train_step``; the atlas: ``optax.adam(2e-2, eps=1e-5)`` over
``diff.render_loss``, as the script runs it): the loss of each step to rtol
1e-4, the trained parameters after step 3 to 1e-4 of their scale.  The
port's Cornell step takes the fused path (K2 and the replay's plain
versions here), JAX's the lockstep path; the atlas takes the lockstep path
on both sides.  The JAX side runs in a child process whose XLA:CPU emits
no FMA (``test_torch_media.jax_reference``), as the port does not: with
FMA a few of the 1,728 pixels' paths part, enough to move a step's loss
by about 2%.  Then the module's entry point in a child process, on the CPU, to
the scripts' CPU criteria.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax_sphere_record
from another_raytracer_tpu_torch import train_demo
from test_torch_media import jax_reference

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
ENTRY_STEPS = 10  # enough for the CPU criteria on both demos

# The JAX side of both protocols: the target at seed 99, the perturbation
# from default_rng(0), STEPS adam steps at seeds 1000 + k.
_JAX_COMMON = """
from another_raytracer_tpu.grad import diff as jdiff
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import render as jrender
from another_raytracer_tpu.ops import vec3 as jvec3
kw = dict(width=W, height=H, spp=SPP, samples_per_pass=1, max_depth=DEPTH,
          t_min=1e-3)
def target_of(scene, cam):
    acc, _ = jax.jit(lambda s, c: jrender.render_radiance(
        s, c, jnp.uint32(99), differentiable=True, **kw))(scene, cam)
    return jnp.asarray(jvec3.to_numpy(acc).astype(np.float32) / SPP)
"""

_JAX_CORNELL = _JAX_COMMON + """
from another_raytracer_tpu.models import library as jlib
scene, params = jlib.cornell_box()
cam = jcam.make_camera(aspect_ratio=W / H, **params)
target = target_of(scene, cam)
true_ca = np.asarray(scene.tex_ca)
rng = np.random.default_rng(0)
pert_ca = np.clip(true_ca * rng.uniform(0.4, 1.9, true_ca.shape), 0.0, 20.0)
out["err0"] = np.abs(pert_ca - true_ca).mean()
pscene = scene.replace(tex_ca=jnp.asarray(pert_ca.astype(np.float32)),
                       background=scene.background + 0.05)
state, step = jdiff.make_train_step(pscene, cam, target, learning_rate=5e-2,
                                    **kw)
losses = []
for k in range(STEPS):
    state, loss = step(state, jnp.uint32(1000 + k))
    losses.append(float(loss))
out["losses"] = np.asarray(losses)
out["params"] = np.asarray(state.params["tex_ca"])
"""

_JAX_ATLAS = _JAX_COMMON + """
import optax
from another_raytracer_tpu.models.scene import SceneBuilder
small = np.load(TEXELS)
b = SceneBuilder(background=(0.70, 0.80, 1.00), seed=7)
b.sphere((0, 0, 0), 2.0, b.lambertian(texture=b.image_texture(small)))
b.sphere((0, -1002.0, 0), 1000.0, b.lambertian(color=(0.5, 0.5, 0.5)))
scene = b.build()
cam = jcam.make_camera(lookfrom=(0, 0, 12), lookat=(0, 0, 0), vfov=22.0,
                       aspect_ratio=W / H)
target = target_of(scene, cam)
true_atlas = np.asarray(scene.atlas)
tparams, _ = jdiff.split_params(scene, ("atlas",))
g0 = jdiff.render_value_and_grad(tparams, scene, cam, target,
                                 jnp.uint32(556), **kw)[1]["atlas"]
wt = np.abs(np.asarray(g0)).sum(-1)
out["observed"] = wt > 0.1 * wt.max()
rng = np.random.default_rng(0)
pert = np.clip(true_atlas * rng.uniform(0.2, 2.5, true_atlas.shape)
               + rng.uniform(0.0, 0.25, true_atlas.shape),
               0.0, 1.0).astype(np.float32)
pscene = scene.replace(atlas=jnp.asarray(pert))
opt = optax.adam(2e-2, eps=1e-5)
params = {"atlas": jnp.asarray(pert)}
opt_state = opt.init(params)

@jax.jit
def step_fn(params, opt_state, seed):
    loss, grads = jax.value_and_grad(jdiff.render_loss)(
        params, pscene, cam, target, seed, **kw)
    upd, opt_state = opt.update(grads, opt_state)
    return optax.apply_updates(params, upd), opt_state, loss

losses = []
for k in range(STEPS):
    params, opt_state, loss = step_fn(params, opt_state, jnp.uint32(1000 + k))
    losses.append(float(loss))
out["losses"] = np.asarray(losses)
out["params"] = np.asarray(params["atlas"])
"""


def jax_protocol(script, size, **paths):
    w, h, spp, depth = size
    head = f"W, H, SPP, DEPTH, STEPS = {w}, {h}, {spp}, {depth}, {STEPS}\n"
    return jax_reference(head + script, **paths)


def steps_match(demo, want):
    for k in range(STEPS):
        np.testing.assert_allclose(float(demo.step(k)), want["losses"][k],
                                   rtol=1e-4, err_msg=f"step {k}")
    name = "tex_ca" if demo.name == "cornell" else "atlas"
    got = demo.params[name].detach().numpy()
    scale = max(np.abs(want["params"]).max(), 1e-9)
    np.testing.assert_allclose(got, want["params"], atol=1e-4 * scale, rtol=0)


def test_cornell_protocol_matches_jax():
    demo = train_demo.cornell_demo("cpu", cpu=True)
    w, h, spp, depth = train_demo.CORNELL["cpu"]
    assert demo.kw == dict(width=w, height=h, spp=spp, samples_per_pass=1,
                           max_depth=depth, t_min=1e-3)
    want = jax_protocol(_JAX_CORNELL, train_demo.CORNELL["cpu"])
    assert demo.err0 == pytest.approx(float(want["err0"]))
    steps_match(demo, want)


def test_atlas_protocol_matches_jax(tmp_path):
    """On a texture made from a seed (no asset is needed): the observed
    texels' mask, then three steps."""
    image = np.random.default_rng(3).uniform(0.0, 1.0, (32, 64, 3))
    demo = train_demo.atlas_demo("cpu", cpu=True, image=image)
    tex = train_demo.ATLAS_TEXELS["cpu"]
    small = train_demo.box_down(image, 32 // tex[1], 64 // tex[0])
    assert small.shape == (tex[1], tex[0], 3)
    np.save(tmp_path / "texels.npy", small)
    # The atlas lies on a sphere: JAX's record re-projects its hits as the
    # port's does, and XLA rounds each operation as written
    # (jax_sphere_record): with its rewrites on, one lane of step 2 parts
    # from the port's and that step's loss is off by 3.7e-4-3.9e-4 of its
    # 1e-4 on every texture seed tried (3-8); without them, by 1.3e-6-1.9e-6.
    want = jax_protocol(
        jax_sphere_record.EXACT_XLA + jax_sphere_record.SNIPPET + _JAX_ATLAS,
        train_demo.ATLAS["cpu"], TEXELS=str(tmp_path / "texels.npy"))
    np.testing.assert_array_equal(demo.observed, want["observed"])
    assert 0 < want["observed"].mean() < 1
    steps_match(demo, want)


@pytest.mark.parametrize("atlas", [False, True])
def test_entry_point_meets_cpu_criteria(tmp_path, atlas):
    out = tmp_path / "record.json"
    args = ["--cpu", "--steps", str(ENTRY_STEPS), "--out", str(out)]
    if atlas:
        args.append("--atlas")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run(
        [sys.executable, "-m", "another_raytracer_tpu_torch.train_demo",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    assert lines[-2] == "PASS"
    assert json.loads(out.read_text()) == rec
    assert rec["passed"] and rec["criteria"] == "cpu" and not rec["failed"]
    assert rec["steps"] == ENTRY_STEPS and rec["backend"] == "cpu"
    assert rec["card"] is None
    # The plain versions launch no kernel.
    assert set(rec["launches"].values()) == {0}
    first, final = rec["loss_curve"][0][1], rec["loss_curve"][-1][1]
    assert final < 0.6 * first
    if atlas:
        assert rec["texture"] in ("earthmap",
                                  "utils/jpeg_samples/baseline_420.jpg")
        err = rec["atlas_mean_abs_err_observed"]
    else:
        err = rec["tex_ca_mean_abs_err"]
    assert err["recovered"] < err["perturbed"]


def test_needs_a_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_demo.main(["--steps", "1"])
