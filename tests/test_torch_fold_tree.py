"""``intersect.fold_tree``, the one statement of when the forward wavefront
folds K5's winner record, on every library scene at widths on both sides of
each gate: as a table, and against the two decisions it replaced (the
wavefront's ``fold_tri`` / ``fold_sph`` and ``closest_hit``'s ``give_aux`` /
``give_sph_aux``, each switch at the one value it ever had).  No JAX."""

import pytest
import torch

import chip_smoke
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import intersect

torch.set_num_threads(1)

SPH, TRI = intersect.FOLD_SPH_MIN_B, intersect.FOLD_RECORD_MIN_B
WIDTHS = (1, SPH - 1, SPH, TRI - 1, TRI, 388_800)

# scene -> (the tree it folds, the gate from which it does); None: never.
TABLE = {
    "random_scene": ("sphere", SPH),
    "two_spheres": None,
    "two_perlin_spheres": None,
    "earth": None,
    "simple_light": None,
    "cornell_box": None,
    "cornell_smoke": None,
    "final_scene": ("sphere", SPH),
    "mesh_scene": ("planar", TRI),
}


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Every library scene on the CPU, the mesh on a small capsule."""
    obj = chip_smoke.write_capsule(str(tmp_path_factory.mktemp("mesh")),
                                   8, 6, 16)
    out = {}
    for name in TABLE:
        kw = {"obj_path": obj} if name == "mesh_scene" else {}
        out[name] = getattr(library, name)(device="cpu", **kw)[0]
    return out


def two_decisions(scene, width):
    """The same rule as two decisions, as the wavefront once made it:
    ``_advance`` asked for a record where either tree passed its gate, and
    ``closest_hit`` worked out which tree's record to return."""
    fold_tri = scene.tri_in_bvh and width >= intersect.FOLD_RECORD_MIN_B
    fold_sph = (scene.sph_in_bvh and scene.n_bvh_nodes == 0
                and scene.sph_fold_safe
                and width >= intersect.FOLD_SPH_MIN_B)
    want_aux = fold_tri or fold_sph
    give_aux = want_aux and scene.n_bvh_nodes > 0
    give_sph_aux = (want_aux and scene.n_sph_bvh_nodes > 0
                    and scene.n_bvh_nodes == 0 and scene.sph_fold_safe)
    assert not (give_aux and give_sph_aux)
    return "planar" if give_aux else "sphere" if give_sph_aux else None


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", list(TABLE))
def test_fold_tree(name, width, scenes):
    scene = scenes[name]
    got = intersect.fold_tree(scene, width)
    row = TABLE[name]
    assert got == (row[0] if row and width >= row[1] else None)
    assert got == two_decisions(scene, width)


@pytest.mark.parametrize("tree", ["planar", "sphere", "rect"])
def test_k5_variant(tree):
    """The variant ``_fold_bvh`` runs on each tree with and without its
    fold: only the folded tree folds; the planar tree walks its precomputed
    geometry and folds the full record."""
    for fold in (None, "planar", "sphere"):
        record, full, pre = intersect.k5_variant(tree, fold)
        assert record == (fold == tree)
        assert full == (record and tree == "planar")
        assert pre == (tree == "planar")
