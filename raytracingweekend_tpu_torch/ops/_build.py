"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` of the package, one process a source,
all started together, and links the objects into one shared library with a
plain C interface, in `raytracingweekend_tpu_torch/_build/` (ignored by
git), at first use; the library's file name carries a hash of the
sources, their shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header is rebuilt. The library is loaded
with ctypes: no torch.utils.cpp_extension, no ninja, nothing downloaded.
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
NVCC_FLAGS = COMPILE_FLAGS + LINK_FLAGS


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build the "
                       "port's kernels): put it on PATH")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librtw_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless the current build exists: one nvcc per
    source, all started together, then one link. Returns (library path,
    seconds spent compiling and linking). Raises RuntimeError if nvcc
    fails; its output (ptxas register and spill report included) is kept
    beside the library as `<library>.log`."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    rcs = [proc.returncode for proc in procs]
    if not any(rcs):
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(link.stdout + link.stderr)
        rcs.append(link.returncode)
    secs = time.perf_counter() - t0
    log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if any(rcs):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exits {rcs}):\n{log}")
    lib.with_name(lib.name + ".log").write_text(log)
    os.replace(tmp, lib)
    return lib, secs


def build_log() -> str:
    """nvcc's output for the current build ('' if it was not built here)."""
    log = library_path().with_name(library_path().name + ".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the kernel library."""
    lib, _ = build()
    return ctypes.CDLL(str(lib))
