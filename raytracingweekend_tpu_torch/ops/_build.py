"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` of the package, one process a source,
all started together, and links the objects into one shared library with a
plain C interface, in `raytracingweekend_tpu_torch/_build/` (ignored by
git), at first use; the library's file name carries a hash of the
sources, their shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header is rebuilt. A measurement build, into a library of its
own: another checkout's `csrc/` builds every source there; the `-D`
defines of tools/culled_ab.py's instrumented kernels build `megakernel.cu`
and `sweep_twin.cu` (K1-K5s and K8, which share the dense slot loop)
alone. The library
is loaded with ctypes: no torch.utils.cpp_extension, no ninja, nothing
downloaded.
The build needs the CUDA toolkit (`nvcc` on PATH or under
/usr/local/cuda/bin) and targets Hopper, sm_90a.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false: the kernels write every FMA out (fmaf) so that they round
# like their plain PyTorch versions; nvcc contracts nothing else.
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas",
                 "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build the "
                       "port's kernels): put it on PATH")


def _sources(defines: tuple, csrc: Path) -> list:
    if not defines:
        return sorted(Path(csrc).glob("*.cu"))
    return [Path(csrc) / "megakernel.cu", Path(csrc) / "sweep_twin.cu"]


def _flags(defines: tuple) -> tuple:
    return COMPILE_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(defines: tuple = (), csrc: Path = CSRC) -> Path:
    """Where the library for the current sources and flags lives: the
    kernels', or the measurement build of `defines` / `csrc`'s."""
    h = hashlib.sha256(" ".join(_flags(defines) + LINK_FLAGS).encode())
    for src in sorted([*_sources(defines, csrc),
                       *Path(csrc).glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librtw_kernels_{h.hexdigest()[:16]}.so"


def build(defines: tuple = (), csrc: Path = CSRC) -> tuple[Path, float]:
    """Compile the kernels (or a measurement build, see `library_path`)
    unless that build exists; see `build_all`. Returns (library path,
    seconds spent)."""
    return build_all([(defines, csrc)])[0]


def build_all(builds: list) -> list:
    """Compile each of `builds`, (defines, csrc) pairs (see
    `library_path`; ((), CSRC) the kernels), that does not exist yet: one
    nvcc per source and build, all started together, then one link a
    build. Returns [(library path, seconds from
    the start to its link's end; 0.0 if it existed)]. Raises RuntimeError
    if nvcc fails (after stopping the other builds); its output (ptxas
    register and spill report included) is kept beside each library as
    `<library>.log`."""
    jobs = []
    t0 = time.perf_counter()
    nvcc = _nvcc()
    for defines, csrc in builds:
        lib = library_path(defines, csrc)
        if lib.exists():
            jobs.append((lib, None, None, []))
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        srcs = _sources(defines, csrc)
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *_flags(defines), "-c", str(src),
                                   "-o", str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        jobs.append((lib, tmp, objs, procs))
    out = []
    try:
        for lib, tmp, objs, procs in jobs:
            if tmp is None:
                out.append((lib, 0.0))
                continue
            logs = [proc.communicate()[0] for proc in procs]
            rcs = [proc.returncode for proc in procs]
            if not any(rcs):
                link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                                       *map(str, objs)], capture_output=True,
                                      text=True)
                logs.append(link.stdout + link.stderr)
                rcs.append(link.returncode)
            log = "".join(logs)
            for obj in objs:
                obj.unlink(missing_ok=True)
            if any(rcs):
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed (exits {rcs}):\n{log}")
            lib.with_name(lib.name + ".log").write_text(log)
            os.replace(tmp, lib)
            out.append((lib, time.perf_counter() - t0))
    finally:
        for _, tmp, objs, procs in jobs:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for obj in objs or ():
                obj.unlink(missing_ok=True)
    return out


def build_log(defines: tuple = (), csrc: Path = CSRC) -> str:
    """nvcc's output for the current build ('' if it was not built here)."""
    lib = library_path(defines, csrc)
    log = lib.with_name(lib.name + ".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(defines: tuple = (), csrc: Path = CSRC) -> ctypes.CDLL:
    """Build if needed, then load the kernel library (or a measurement
    build, see `library_path`)."""
    lib, _ = build(defines, csrc)
    return ctypes.CDLL(str(lib))
