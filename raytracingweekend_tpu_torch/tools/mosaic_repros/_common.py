"""What the repro modules share: the launcher of the kernel library's
entries, the wrappers' refusal, timing and the bound of a launch."""
from __future__ import annotations

import contextlib
import ctypes
import functools
import struct
import time

import torch

from .. import card_line
from ...ops import _build

HBM_BYTES_PER_S = 3.35e12     # H100 SXM
FP32_PEAK = 67e12             # outside the tensor cores
TF32_PEAK = 495e12            # dense tensor cores
LAUNCHES = 200                # back-to-back launches a timing
F32 = torch.float32
_card_line = functools.lru_cache(maxsize=None)(card_line)   # one smi call


def cuda_state() -> tuple:
    """The number of CUDA devices, and PyTorch's readers of the current
    device's index and of a device's current stream as a raw handle (an
    int: no Stream object is built; chip_smoke.py phase 26 times it
    against torch.cuda.current_stream(i).cuda_stream)."""
    return (torch.cuda.device_count(), torch._C._cuda_getDevice,
            torch._C._cuda_getCurrentRawStream)


class Entry:
    """One C entry of the kernel library (csrc/mosaic_repros.cu) and the
    launch counts of its kernels.

    `launch(key, dev, *args)` packs `args` and, last, the raw handle of
    the current stream of CUDA device `dev` into the entry's argument
    block (one int64 a slot: ints and addresses), and calls the entry,
    making `dev` the current device only when it is not (on a machine of
    one card it always is, and the current device is not read). It
    raises RuntimeError naming `kernel` and the library's error string
    when the entry returns non-zero (the card refused the launch), else
    adds one to `counts[key]`. The ctypes function, its argtypes, the
    block's packer, the stream reader and the card count are resolved at
    the first launch (the library is built then), never again. `lib`
    gives the library (default: the kernels', ops/_build.py)."""

    def __init__(self, kernel: str, name: str, slots: int, counts: dict,
                 lib=_build.load):
        self.kernel, self.name, self.slots = kernel, name, slots
        self.counts, self._lib = counts, lib
        self.launch = self._bind_and_launch

    def _bind_and_launch(self, key, dev, *args) -> None:
        self.launch = self.bind()
        self.launch(key, dev, *args)

    def bind(self):
        """The launch function, bound to the entry (see the class)."""
        lib = self._lib()
        fn = getattr(lib, self.name)
        fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
        err = lib.rtw_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        pack = struct.Struct(f"{self.slots + 1}q").pack
        cards, current, raw_stream = cuda_state()
        many, kernel, counts = cards > 1, self.kernel, self.counts

        def launch(key, dev, *args) -> None:
            if many and dev != current():
                with torch.cuda.device(dev):
                    rc = fn(pack(*args, raw_stream(dev)))
            else:
                rc = fn(pack(*args, raw_stream(dev)))
            if rc:
                raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                                   f"({err(rc).decode()})")
            counts[key] += 1
        return launch


def need_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper takes CUDA tensors on one device, contiguous:
    raise ValueError naming kernel `name` for the first that is not."""
    dev = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors; got one on "
                             f"{t.device}")
        if t.get_device() != dev:
            raise ValueError(f"{name} needs its tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def refuse(name: str, *tensors: torch.Tensor) -> None:
    """The end of a wrapper's refusal, once its one combined check failed
    and its shape checks raised nothing: need_cuda's ValueError, or one
    that names no cause."""
    need_cuda(name, *tensors)
    raise ValueError(f"{name} does not take these tensors")


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
             peak: float = FP32_PEAK, library=None, library_under=None,
             forms_equal=None, as_expected=None) -> dict:
    """One JSON row of a formulation: `fn` the wrapper (the kernel on the
    card), `plain` its plain version, `library` a (callable, description)
    of one PyTorch call of the same function or (None, why not), timed
    inside `library_under()` where given (a context entered once around
    its whole timing); `got` / `want` the two outputs on the same inputs,
    held within `tol` (elementwise, a number or a tensor)."""
    us = launch_us(fn, device, launches)
    plain_us = launch_us(plain, device, launches)
    b_us, b_by = bound(nbytes, ops, peak)
    lib_fn, lib_what = library if library else (None, "none")
    lib_us = None
    if lib_fn is not None:
        with (library_under or contextlib.nullcontext)():
            lib_us = launch_us(lib_fn, device, launches)
    err = (got.double() - want.double()).abs()
    return {"kernel": kernel, "name": name, "shape": shape,
            "us": us, "plain_us": plain_us, "bound_us": b_us,
            "bound_by": b_by, "library_us": lib_us,
            "library": lib_what,
            "max_abs_err": err.max().item() if err.numel() else 0.0,
            "agrees": bool(torch.all(err <= tol)),
            "forms_equal": forms_equal, "as_expected": as_expected,
            "device": _card_line(torch.device(device).type)}
