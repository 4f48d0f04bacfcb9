"""The scaling harness (``scaling_harness.py``, the counterpart of
``scripts/scaling_harness.py``) on the CPU: its renders over partitions of
1, 2 and 3 CPU shards are bit-equal to single mode (the RNG keys on
absolute (pixel, sample) ids), its output lines parse, and two processes
over gloo measure the whole frame through ``parallel/multihost.py``."""

import io
import multiprocessing
import re
import socket
from contextlib import redirect_stdout

import pytest
import torch

from another_raytracer_tpu_torch import scaling_harness
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.parallel import sharding

torch.set_num_threads(1)

SMALL = ["--width", "24", "--height", "12", "--spp", "2", "--depth", "3",
         "--reps", "1"]
TIMEOUT = 240  # seconds per process
LINE = re.compile(r"^devices=\s*(\d+)\s+([\d.]+) Mrays/s\s+"
                  r"efficiency=\s*([\d.]+)%(  OK \(>=80%\)|  BELOW TARGET)?$")


def test_sizes():
    assert scaling_harness.sizes(1) == [1]
    assert scaling_harness.sizes(3) == [1, 2, 3]
    assert scaling_harness.sizes(6) == [1, 2, 4, 6]
    assert scaling_harness.sizes(8) == [1, 2, 4, 8]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_renders_equal_single_mode(n):
    args = scaling_harness.parse_args(SMALL)
    scene, params = library.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=2.0, device="cpu", **params)
    want, want_segs = trender.render_radiance(
        scene, cam, scaling_harness.SEED, width=24, height=12, spp=2,
        samples_per_pass=1, max_depth=3, t_min=scaling_harness.T_MIN)
    part = sharding.hybrid_partition(n, 1, devices=["cpu"] * n)
    (got, segs), seconds = scaling_harness.measure(
        scaling_harness.render_fn(scene, cam, args, part), ["cpu"] * n, 1)
    assert seconds > 0 and int(segs) == int(want_segs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_output_lines_parse():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert scaling_harness.main(["--cpu", "3", *SMALL]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[:2] == ["backend=cpu processes=1 global_devices=3",
                         "workload: cornell 24x12 spp=2 depth=3"]
    assert lines[2].startswith("devices repeat (cpu, cpu, cpu)")
    rows = [LINE.match(ln) for ln in lines[3:]]
    assert all(rows) and len(rows) == 3, lines
    assert [int(m.group(1)) for m in rows] == [1, 2, 3]
    assert float(rows[0].group(3)) == 100.0 and rows[0].group(4) is None
    assert all(float(m.group(2)) > 0 and m.group(4) for m in rows[1:])


def _worker(rank, port, path):
    torch.set_num_threads(1)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = scaling_harness.main(
            ["--cpu", "1", "--coordinator", f"127.0.0.1:{port}",
             "--nprocs", "2", "--pid", str(rank), *SMALL])
    with open(path, "w") as f:
        f.write(f"rc={rc}\n" + buf.getvalue())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    paths = [tmp_path / f"rank{r}.txt" for r in range(2)]
    procs = [ctx.Process(target=_worker, args=(r, port, str(p)))
             for r, p in enumerate(paths)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT)
        assert not any(p.is_alive() for p in procs)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
    assert all(p.exitcode == 0 for p in procs)
    for path in paths:
        lines = path.read_text().splitlines()
        assert lines[:3] == ["rc=0",
                             "backend=cpu processes=2 global_devices=2",
                             "workload: cornell 24x12 spp=2 depth=3"]
        m = re.match(r"^devices=2 \(x2 processes\)\s+([\d.]+) Mrays/s$",
                     lines[3])
        assert m and float(m.group(1)) > 0, lines
        assert lines[4].startswith("compare with a recorded one-host run")
