"""The replay backward's kernel design, held on the CPU: a torch model of
``csrc/mega_replay.cu``'s order (each lane's rows in reverse chunks, a chunk
skipped warp-wide where no lane's row in it changes anything, the compact
tex_cb rows of the checker textures only, the dielectric sentinel that adds
to no gradient) runs on the plain record of three scenes and is held
against ``replay_backward_reference`` and JAX's ``_traced_bwd`` (which
takes ``_bwd_large`` above 16 textures) on the same numpy residuals, to
rtol 1e-5 (the sums run in another order).

Then what the wrapper decides without the card: the scene's tex_cb row map,
the shared-memory sizes and the instance it picks, the live-row work of the
bound, and the launch's inputs on K2-shaped views (the record buffer
itself, no copy).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import vec3 as jvec3
from another_raytracer_tpu.ops.pallas import mega_diff as jmd
from another_raytracer_tpu_torch.grad import diff as tdiff
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from another_raytracer_tpu_torch.ops.kernels import mega_diff as tmd
from another_raytracer_tpu_torch.ops.kernels import mega_kernel as tmk
from test_torch_diff import _many_textures_scene

torch.set_num_threads(1)

W, H, SPP, DEPTH = 24, 18, 4, 8
B = W * H
SCENES = {"cornell": jlib.cornell_box, "random_scene": jlib.random_scene,
          "many_textures": _many_textures_scene}


@functools.lru_cache(maxsize=None)
def _record(name):
    """(JAX scene, JAX camera, port scene, codes, tprev V3, ghat numpy
    [3, B]): the plain record of ``name`` and a random cotangent."""
    ref, params = SCENES[name]()
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    port = tscene.scene_from_reference(ref, device="cpu")
    cam = tcam.camera_from_reference(ref_cam, device="cpu")
    _, _, codes, tprev = tmk.trace_regenerative_mega(
        port, cam, torch.arange(B), torch.zeros(B, dtype=torch.int64), 3,
        width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
        max_depth=DEPTH, t_min=1e-3, record_iters=SPP * DEPTH)
    ghat = np.random.default_rng(7).uniform(0.2, 1.0, (3, B)).astype(np.float32)
    return ref, ref_cam, port, codes, tprev, ghat


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    ref, ref_cam, _, codes, tprev, ghat = _record(name)
    res = (jnp.asarray(codes.numpy()),
           jvec3.V3(*(jnp.asarray(t.numpy()) for t in tprev)),
           ref.tex_ca, ref.tex_cb, ref.background, ref, ref_cam,
           jnp.arange(B, dtype=jnp.uint32), jnp.zeros(B, jnp.uint32))
    cfg = (W, H, 1, SPP, DEPTH, 1e-3, SPP * DEPTH, True)
    bar = jmd._traced_bwd(cfg, res, (jvec3.V3(*map(jnp.asarray, ghat)), None))[0]
    return tuple(np.asarray(getattr(bar, k))
                 for k in ("tex_ca", "tex_cb", "background"))


def kernel_model(codes, tprev, ghat, ca, cb, bg, flags, slots, chunk):
    """The kernel's walk as tensor ops over lanes: (the compact entries
    [3 (T + C) + 3] summed over lanes, warp-chunks skipped, warp-chunks)."""
    iters, n = codes.shape
    T = ca.shape[0]
    C = slots.checkers
    has_metal = bool(flags & tmd._HAS_METAL)
    odd_routes = bool(flags & tmd._HAS_CHECKER) and C > 0
    pad = -n % 32  # lanes past n: code 0, as the kernel's
    codes = torch.nn.functional.pad(codes, (0, pad))
    tp = [torch.nn.functional.pad(t, (0, pad)) for t in tprev]
    g = torch.nn.functional.pad(torch.stack(tuple(ghat), 1), (0, 0, 0, pad))
    lanes = torch.arange(n + pad)
    sentinel = torch.full((1, 3), 1.0 if flags & tmd._HAS_DIEL else 0.0)
    tab = torch.cat([ca, cb[slots.cb_tex.long()], sentinel])
    cb_row = torch.cat([slots.cb_row.long(), torch.tensor([-1])])
    acc = torch.zeros((n + pad, T + C + 1, 3))  # + a row nothing reads
    gbg = torch.zeros((n + pad, 3))
    r = torch.zeros((n + pad, 3))
    skipped = chunks = 0
    for hi in range(iters, 0, -chunk):
        rows = [it for it in range(hi - 1, hi - 1 - chunk, -1) if it >= 0]
        c = codes[rows]
        matters = ((c & 3) != 0) | (has_metal & ((c & 4) != 0))
        take = matters.any(0).view(-1, 32).any(1)
        skipped += int((~take).sum())
        chunks += take.numel()
        take = take.repeat_interleave(32)[:, None]
        for it in rows:
            code = codes[it].long()
            ev = code & 3
            end = ((code & 4) != 0)[:, None]
            tid = torch.clamp(code >> 4, max=T)
            odd = ((code & 8) != 0) & odd_routes
            row = torch.where(odd & (cb_row[tid] >= 0), T + cb_row[tid], tid)
            row = torch.where(tid == T, T + C, row)
            scat, light, miss = ((ev == k)[:, None] for k in (1, 2, 3))
            gterm = g * torch.stack([t[it] for t in tp], 1)
            r_after = torch.where(end, 0.0, r)
            g_a = torch.where(scat, gterm * r_after, gterm)
            # The sentinel's row (T + C) and idle rows add to no gradient.
            adds = (scat | light) & (tid < T)[:, None] & take
            acc[lanes, row] += torch.where(adds, g_a, 0.0)
            gbg += torch.where(miss & take, gterm, 0.0)
            alb = tab[row]
            new = torch.where(scat, alb * r_after,
                              torch.where(light, alb,
                                          torch.where(miss, bg, r)))
            if has_metal:
                new = torch.where((ev[:, None] == 0) & end, 0.0, new)
            r = torch.where(take, new, r)
    tot = torch.cat([acc[:, :T + C].sum(0).flatten(), gbg.sum(0)])
    return tot, skipped, chunks


@pytest.mark.parametrize("chunk", [1, tmd.REPLAY_CHUNK, 16])
@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_model_matches_plain_and_jax(name, chunk):
    ref, _, port, codes, tprev, ghat = _record(name)
    flags = tmd._flags(port)
    g = tvec3.V3(*map(torch.from_numpy, ghat))
    slots = port.replay_slots()
    tot, skipped, chunks = kernel_model(codes, tprev, g, port.tex_ca,
                                        port.tex_cb, port.background, flags,
                                        slots, chunk)
    assert tot.shape == (3 * (ref.tex_ca.shape[0] + slots.checkers) + 3,)
    got = tmd.replay_gradients(tot, port.tex_ca.shape[0], slots.cb_tex)
    plain = tmd.replay_backward_reference(codes, tprev, g, port.tex_ca,
                                          port.tex_cb, port.background, flags)
    for key, a, b, want in zip(("tex_ca", "tex_cb", "background"), got,
                               plain, _jax_grads(name)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=key)
        np.testing.assert_allclose(a.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=key)
    assert np.abs(_jax_grads(name)[0]).max() > 0
    # The idle suffix of the lanes' rows is skipped warp-wide (at these
    # 32 rows a lane, chunks of 16 are too coarse on Cornell).
    assert skipped < chunks
    if chunk <= 8:
        assert skipped > 0


def test_kernel_model_on_random_rows():
    # Rows of every event, end and odd bit and texture id (the sentinel
    # included).  Warp 1's lanes have an idle suffix from row 16, which the
    # walk skips; warp 0's rows 24-31 are idle but for one metal absorption
    # (event 0 with the end bit) on lane 5, between a light hit above it and
    # a scatter below: that chunk must run, or the scatter's gradient keeps
    # the light's value.  Every texture has a tex_cb row here.
    T, iters, n = 7, 40, 96
    rng = np.random.default_rng(3)
    ev = rng.integers(1, 4, (iters, n)) * (rng.uniform(size=(iters, n)) < 0.4)
    end = (ev > 0) & (rng.uniform(size=(iters, n)) < 0.3)
    codes = (rng.integers(0, T + 1, (iters, n)) * 16 * (ev > 0)
             + 8 * rng.integers(0, 2, (iters, n)) * (ev > 0) + 4 * end + ev)
    codes[24:32, :32] = 0
    codes[16:, 32:64] = 0
    codes[32, 5] = 1 * 16 + 2  # light hit on texture 1
    codes[30, 5] = 4  # metal absorption
    codes[23, 5] = 2 * 16 + 1  # scatter on texture 2
    codes = torch.from_numpy(codes.astype(np.int32))
    tprev = tvec3.V3(*(torch.from_numpy(rng.uniform(0, 1, (iters, n))
                                        .astype(np.float32)) for _ in range(3)))
    ghat = tvec3.V3(*(torch.from_numpy(rng.uniform(0.2, 1, n)
                                       .astype(np.float32)) for _ in range(3)))
    ca, cb = (torch.from_numpy(rng.uniform(0, 1, (T, 3)).astype(np.float32))
              for _ in range(2))
    bg = torch.tensor([0.7, 0.8, 1.0])
    flags = tmd._HAS_CHECKER | tmd._HAS_METAL | tmd._HAS_DIEL
    slots = tmd.ReplaySlots(*(torch.arange(T, dtype=torch.int32),) * 2)
    tot, skipped, chunks = kernel_model(codes, tprev, ghat, ca, cb, bg, flags,
                                        slots, 8)
    assert skipped == 3 and chunks == 15  # warp 1's rows 16-39
    got = tmd.replay_gradients(tot, T, slots.cb_tex)
    plain = tmd.replay_backward_reference(codes, tprev, ghat, ca, cb, bg, flags)
    for a, b in zip(got, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))
        assert float(b.abs().max()) > 0


@pytest.mark.parametrize("name,checkers", [("cornell", 0),
                                           ("random_scene", 1),
                                           ("many_textures", None)])
def test_replay_slots_cover_the_checker_textures(name, checkers):
    # One tex_cb row for each checker texture (scene 1: its ground), and
    # the plain record sets the odd bit on those textures only.
    _, _, port, codes, _, _ = _record(name)
    slots = port.replay_slots()
    checker = port.tex_kind == tscene.TEX_CHECKER
    if checkers is not None:
        assert slots.checkers == checkers
    assert torch.equal(slots.cb_tex.long(), torch.nonzero(checker).flatten())
    assert torch.equal(slots.cb_row[slots.cb_tex.long()],
                       torch.arange(slots.checkers, dtype=torch.int32))
    assert bool((slots.cb_row[~checker] == -1).all())
    live = (codes & 3) != 0
    tid = (codes >> 4)[live & ((codes & 8) != 0)].long()
    assert bool(checker[tid].all())
    if slots.checkers:
        assert tid.numel() > 0


def test_training_steps_share_the_slot_map():
    # The fused step packs the map on merge_params' copy of the scene; the
    # next step's copy, with new leaf values, finds it packed.
    scene, _ = tlib.random_scene(device="cpu")
    params, _ = tdiff.split_params(scene)
    slots = tdiff.merge_params(scene, params).replay_slots()
    stepped = {k: v * 0.5 for k, v in params.items()}
    assert tdiff.merge_params(scene, stepped).replay_slots() is slots
    assert scene.replay_slots() is slots
    # A copy with other texture kinds packs its own map.
    solid = scene.replace(tex_kind=torch.zeros_like(scene.tex_kind))
    assert solid.replay_slots().checkers == 0
    assert scene.replace().replay_slots().checkers == 1


# (T, C, block, instance, shared bytes counted by hand: the albedo rows with
# the sentinel, the tex_cb row map where C > 0, the gradient entries per
# thread or per warp, 4 B each).
SMEM_CASES = [
    (4, 0, 128, tmd.LANE_COLUMNS, 4 * (3 * 5 + 15 * 128)),
    (4, 0, 128, tmd.WARP_TABLES, 4 * (3 * 5 + 15 * 4)),
    (21, 0, 64, tmd.LANE_COLUMNS, 4 * (3 * 22 + 66 * 64)),
    (485, 1, 128, tmd.WARP_TABLES, 4 * (3 * 487 + 485 + 1461 * 4)),
    (485, 1, 32, tmd.LANE_COLUMNS, 4 * (3 * 487 + 485 + 1461 * 32)),
    (3, 3, 256, tmd.WARP_TABLES, 4 * (3 * 7 + 3 + 21 * 8)),
]


@pytest.mark.parametrize("T,C,block,instance,want", SMEM_CASES)
def test_replay_smem_bytes(T, C, block, instance, want):
    assert tmd.replay_smem_bytes(T, C, block, instance) == want


@pytest.mark.parametrize("T,C", [(4, 0), (21, 0), (4, 4), (32, 1), (64, 1),
                                 (485, 1), (485, 0), (485, 485), (2000, 0)])
def test_replay_instance_fits_and_fills_one_wave(T, C):
    instance, block = tmd.replay_instance(T, C)
    smem = tmd.replay_smem_bytes(T, C, block, instance)
    assert smem <= tmd._MAX_SMEM and block % 32 == 0
    # The main paths' shapes: Cornell on the per-lane columns, scene 1 on
    # the per-warp tables in blocks of 31,160 B (7 to an SM's 228 KB).  In
    # between, the instance that was faster on the card: the columns at 32
    # textures, the tables at 64.
    if (T, C) in ((4, 0), (32, 1)):
        assert (instance, block) == (tmd.LANE_COLUMNS, 128)
    if (T, C) == (64, 1):
        assert (instance, block) == (tmd.WARP_TABLES, 128)
    if (T, C) == (485, 1):
        assert (instance, smem) == (tmd.WARP_TABLES, 31160)


def test_replay_instance_refuses_what_no_block_fits():
    with pytest.raises(ValueError):
        tmd.replay_instance(20000, 0)


def test_replay_work_counts_live_rows():
    # 2 iterations x 3 lanes: live rows are those with an event (scatter 1,
    # light 2, miss 3); event 0 (idle, or metal absorption with the end
    # bit) reads no tprev.
    # By 32-byte sectors (8 neighbouring lanes): each row's one sector.
    codes = torch.tensor([[0x11, 0, 4], [3, 0x22 | 8, 0]], dtype=torch.int32)
    work = tmd.replay_work(codes, T=4, C=1)
    rest = 6 * 4 + 3 * 12 + 2 * 4 * (3 * (4 + 1) + 3)
    assert work == dict(rows=6, live_rows=3, bytes=rest + 3 * 12,
                        sector_bytes=rest + 2 * 3 * 32)
    # 2 rows x 20 lanes (sectors of lanes 0-7, 8-15, 16-19): row 0 live on
    # lanes 3 and 9, row 1 on lane 19 only.
    codes = torch.zeros((2, 20), dtype=torch.int32)
    codes[0, 3] = codes[0, 9] = 1
    codes[1, 19] = 2
    work = tmd.replay_work(codes, T=1)
    assert work["live_rows"] == 3
    assert work["sector_bytes"] - work["bytes"] == 3 * 3 * 32 - 3 * 12


def test_replay_inputs_are_the_record_buffer():
    # K2 writes tprev as one [3, iters, B] buffer and hands out its planes
    # as views: the launch reads them where they lie.
    iters, n = 6, 40
    codes = torch.zeros((iters, n), dtype=torch.int32)
    buf = torch.rand((3, iters, n))
    tprev = tvec3.V3(*buf.unbind(0))
    ghat = tvec3.V3(*(torch.rand(n) for _ in range(3)))
    ca, cb, bg = torch.rand(4, 3), torch.rand(4, 3), torch.rand(3)
    none = tmd.ReplaySlots(*(torch.zeros(0, dtype=torch.int32),) * 2)
    ins = tmd.replay_inputs(codes, tprev, ghat, ca, cb, bg, none)
    assert ins[0].data_ptr() == codes.data_ptr()
    for k in range(3):
        assert ins[1 + k].data_ptr() == buf.data_ptr() + 4 * k * iters * n
        assert ins[4 + k].data_ptr() == ghat[k].data_ptr()
    assert ins[-2:] == (none.cb_row, none.cb_tex)
    # A plane that is not contiguous (an expanded cotangent) is made so.
    wide = tvec3.V3(*(torch.ones(1).expand(n) for _ in range(3)))
    ins = tmd.replay_inputs(codes, tprev, wide, ca, cb, bg, none)
    assert all(t.is_contiguous() and t.shape == (n,) for t in ins[4:7])
