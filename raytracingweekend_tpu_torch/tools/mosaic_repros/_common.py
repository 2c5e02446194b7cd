"""What the repro modules share: the kernel library's entry points, launch
checks, timing and the bound of a launch."""
from __future__ import annotations

import ctypes
import functools
import time

import torch

from .. import card_line
from ...ops import _build

HBM_BYTES_PER_S = 3.35e12     # H100 SXM
FP32_PEAK = 67e12             # outside the tensor cores
TF32_PEAK = 495e12            # dense tensor cores
LAUNCHES = 200                # back-to-back launches a timing
_card_line = functools.lru_cache(maxsize=None)(card_line)   # one smi call


@functools.lru_cache(maxsize=None)
def kernel_lib() -> ctypes.CDLL:
    """The built kernel library (ops/_build.py) with the repros' argtypes."""
    lib = _build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("rtw_repro_iota_launch", [i, p, i, i, p]),
                       ("rtw_repro_slice_launch", [i, p, p, p, i, i, i, p]),
                       ("rtw_repro_scalar_reduce_launch", [p, p, i, i, p]),
                       ("rtw_repro_cull_launch", [i, p, p, p, i, i, p]),
                       ("rtw_repro_dot_k3_launch", [i, p, p, p, i, i, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, fn: str, *args, device) -> None:
    """Call the library's `fn` on the current stream of `device`; raise
    RuntimeError naming kernel `name` if the card refused the launch."""
    lib = kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.rtw_error_string(rc).decode()})")


def need_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper takes CUDA float32 tensors, contiguous."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors; got one on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def launch_us(fn, device, n: int = LAUNCHES) -> float:
    """Mean µs of one fn() over n calls in a row: CUDA events around them
    on the card (after two warm-up calls), the host clock on the CPU."""
    fn()
    fn()
    if torch.device(device).type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e6 / n


def bound(bytes_moved: float, ops: float, peak: float = FP32_PEAK) -> tuple:
    """The least time of the work on an H100, in µs, and what bounds it:
    max(bytes / 3.35 TB/s, operations / the unit's peak)."""
    b, o = bytes_moved / HBM_BYTES_PER_S, ops / peak
    return max(b, o) * 1e6, "bytes" if b >= o else "operations"


def where(row: dict) -> str:
    """'on the card' or 'in the plain version (CPU)', for a verdict."""
    return ("in the plain version (CPU)" if row["device"].startswith("cpu")
            else "on the card")


def make_row(kernel: str, name: str, shape: str, fn, plain, device, launches,
             nbytes: float, ops: float, got, want, tol=0.0,
             peak: float = FP32_PEAK, library=None, forms_equal=None,
             as_expected=None) -> dict:
    """One JSON row of a formulation: `fn` the wrapper (the kernel on the
    card), `plain` its plain version, `library` a (callable, description)
    of one PyTorch call of the same function or (None, why not); `got` /
    `want` the two outputs on the same inputs, held within `tol`
    (elementwise, a number or a tensor)."""
    us = launch_us(fn, device, launches)
    plain_us = launch_us(plain, device, launches)
    b_us, b_by = bound(nbytes, ops, peak)
    lib_fn, lib_what = library if library else (None, "none")
    err = (got.double() - want.double()).abs()
    return {"kernel": kernel, "name": name, "shape": shape,
            "us": us, "plain_us": plain_us, "bound_us": b_us,
            "bound_by": b_by,
            "library_us": (None if lib_fn is None
                           else launch_us(lib_fn, device, launches)),
            "library": lib_what,
            "max_abs_err": err.max().item() if err.numel() else 0.0,
            "agrees": bool(torch.all(err <= tol)),
            "forms_equal": forms_equal, "as_expected": as_expected,
            "device": _card_line(torch.device(device).type)}
