"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each target of ``TARGETS`` is one ``csrc/*.cu`` source compiled by ``nvcc``
with the common flags plus its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) under
``another_raytracer_tpu_torch/_build/``, keyed by a hash of the source, the
headers it may include (``csrc/*.cuh``) and the flags: a fresh checkout
builds by itself, and an edited source or header rebuilds.
The compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<target>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# target -> (source in csrc/, extra nvcc flags).  The megakernel source is
# built three times: its forward instances (K1, K3) as is, its record
# instances (K2, K3's) without FMA contraction (csrc/mega_kernel.cu says
# why), and its counting instances (the sweep's and K3's walk's) with the
# record build's arithmetic (a measurement; the port's paths never launch
# them).  The BVH (K5) and Perlin
# (K4) kernels contract no FMA either, so they equal their plain versions
# bit for bit, and so does the bounce kernel, which equals the wavefront's
# eager step.
TARGETS = {
    "mega_kernel": ("mega_kernel.cu", ()),
    "mega_kernel_record": ("mega_kernel.cu", ("-DART_RECORD", "-fmad=false")),
    "mega_kernel_count": ("mega_kernel.cu", ("-DART_COUNT", "-fmad=false")),
    "mega_replay": ("mega_replay.cu", ()),
    "bvh_kernel": ("bvh_kernel.cu", ("-fmad=false",)),
    "bvh_kernel_count": ("bvh_kernel.cu", ("-DART_COUNT", "-fmad=false")),
    "perlin_kernel": ("perlin_kernel.cu", ("-fmad=false",)),
    "bounce_kernel": ("bounce_kernel.cu", ("-fmad=false",)),
}

_LOADED: dict = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built at first use and "
        "need the CUDA toolkit (nvcc on PATH or under $CUDA_HOME/bin)")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + TARGETS[name][1]


def library_path(name: str) -> Path:
    src = (CSRC_DIR / TARGETS[name][0]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile target ``name`` unless a library for this exact source and
    flags is already built.  Returns (library path, seconds compiling)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0
    return out, compile_library(
        out, [nvcc_path(), *_flags(name)], [CSRC_DIR / TARGETS[name][0]], name)


def compile_library(out: Path, compiler: list, sources: list,
                    what: str) -> float:
    """Run ``compiler + ["-o", <temporary>] + sources`` and move the result
    to ``out``, with the compiler's report beside it as ``<out>.log``.
    Raises RuntimeError with the command and its report when the compiler
    fails.  Returns the seconds compiling."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*compiler, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}"
    if res.returncode != 0:
        raise RuntimeError(f"building {what} failed:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return seconds


def build_all() -> dict:
    """Build every target at once, one nvcc process each, in parallel
    threads.  Returns {target: (library path, seconds compiling)}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(TARGETS)) as pool:
        return dict(zip(TARGETS, pool.map(build, TARGETS)))


def load(name: str) -> ctypes.CDLL:
    """The built library of target ``name``, building it if needed."""
    if name not in _LOADED:
        path, _ = build(name)
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]


def build_log(name: str) -> str:
    """The compiler's report for the current source (after ``build``)."""
    return library_path(name).with_suffix(".log").read_text()
