"""Two processes render one frame on ``torch.distributed`` (``gloo``, CPU):
each renders its stripes (``parallel/multihost.py``) and gathers every
rank's into the full frame.  Both ranks must hold the same frame, bit-equal
to a one-process render (the RNG keys on absolute (pixel, sample) ids).
The scene and size are those of the JAX package's multihost worker
(scripts/multihost_worker.py: 24x12, spp 4, depth 3)."""

import multiprocessing
import socket

import numpy as np
import pytest
import torch

from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from another_raytracer_tpu_torch.parallel import multihost

W, H, SPP, DEPTH = 24, 12, 4, 3
KW = dict(width=W, height=H, spp=SPP, samples_per_pass=2, max_depth=DEPTH,
          t_min=1e-3)
TIMEOUT = 240  # seconds per process


def _scene():
    b = SceneBuilder(background=(0.6, 0.7, 0.9), seed=4)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.4, 0.7, 0.3)))
    b.sphere((0, 0, -1), 0.5, b.metal((0.8, 0.8, 0.8), 0.1))
    cam = tcam.make_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -1), vfov=60,
                           aspect_ratio=W / H, device="cpu")
    return b.build(device="cpu"), cam


def _worker(rank, world, port, outdir):
    torch.set_num_threads(1)
    init = f"tcp://127.0.0.1:{port}"
    assert multihost.initialize("gloo", init, world, rank) == (rank, world)
    # A repeated call is a no-op.
    assert multihost.initialize("gloo", init, world, rank) == (rank, world)
    assert multihost.is_primary() == (rank == 0)
    scene, cam = _scene()
    frame, segments = multihost.render_radiance_multihost(scene, cam, 7, **KW)
    np.save(f"{outdir}/radiance_{rank}.npy", frame)
    np.save(f"{outdir}/segments_{rank}.npy", np.int64(segments))
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_render(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, 2, port, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT)
            assert not p.is_alive(), "a rank did not finish in time"
            assert p.exitcode == 0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    r0, r1 = (np.load(tmp_path / f"radiance_{r}.npy") for r in range(2))
    s0, s1 = (int(np.load(tmp_path / f"segments_{r}.npy")) for r in range(2))
    np.testing.assert_array_equal(r0, r1)
    torch.set_num_threads(1)
    scene, cam = _scene()
    ref, segs = trender.render_radiance(scene, cam, 7, **KW)
    np.testing.assert_array_equal(r0, tvec3.to_numpy(ref))
    assert s0 == s1 == int(segs)


def test_one_process_and_backends():
    """Without a process group the stripes are the whole frame, and the
    backend is never picked for the caller."""
    torch.set_num_threads(1)
    scene, cam = _scene()
    frame, segments = multihost.render_radiance_multihost(scene, cam, 7, **KW)
    ref, segs = trender.render_radiance(scene, cam, 7, **KW)
    np.testing.assert_array_equal(frame, tvec3.to_numpy(ref))
    assert segments == int(segs) and multihost.is_primary()
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("mpi")
