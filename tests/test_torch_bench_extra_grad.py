"""Port vs JAX: the gradient rows of ``bench_extra.py`` (the forward and
adaptive rows, and how the JAX side runs, are in
``test_torch_bench_extra.py``).

Every ``grad`` row at a tiny size through the port's ``run_grad`` and the
JAX script's, the mesh rows on a small capsule.  The loss must agree to
rtol 1e-4 and the gradient norm to 1e-2 relative (with the segments to the
bar of tests/test_mega.py:37-45).  Routes differ by design: on the CPU the
JAX package leaves every row on its autodiff path, while the port's fused
path (the plain versions of K2 or K3's record instance and the replay)
takes sphere_ground_grad, metal_diel_grad and random_grad, whose
megakernel takes sphere hits as ``o + t d`` here, as JAX's autodiff path
does (``megakernel_like_jax``, tests/jax_sphere_record.py).
"""

import numpy as np
import pytest
import torch

from another_raytracer_tpu_torch import bench_extra
from test_torch_bench_extra import jax_rows
from jax_sphere_record import megakernel_like_jax  # noqa: F401

torch.set_num_threads(1)

SIZE = (24, 12, 2, 2)  # W, H, spp, depth
ROWS = [n for n, row in bench_extra.CONFIGS.items() if row[5] == "grad"]
FUSED = {"sphere_ground_grad", "metal_diel_grad", "random_grad"}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return jax_rows(ROWS, {"grad": SIZE},
                    tmp_path_factory.mktemp("bench_extra_grad"))


@pytest.mark.parametrize("name", ROWS)
def test_grad_row_matches_jax(jax_side, name, monkeypatch,
                              megakernel_like_jax):
    from another_raytracer_tpu_torch.ops.kernels import mega_diff

    obj, want = jax_side
    seen = []
    enabled = mega_diff.enabled
    monkeypatch.setattr(mega_diff, "enabled",
                        lambda *a, **k: seen.append(enabled(*a, **k))
                        or seen[-1])
    wl = bench_extra.setup(name, "cpu", obj, SIZE)
    rec, run = bench_extra.measure(wl)
    assert any(seen) == (name in FUSED)
    assert rec["config"] == "24x12 spp2 depth2 grad" and rec["fwd_bwd"]
    loss, grads = run.out
    np.testing.assert_allclose(float(loss), float(want[name + "/loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(rec["grad_norm"],
                               float(want[name + "/grad_norm"]), rtol=1e-2)
    assert rec["grad_leaves"] == int(want[name + "/grad_leaves"]) == 10
    segs = int(want[name + "/segments"])
    assert abs(rec["segments"] - segs) <= max(4, 0.01 * segs)
