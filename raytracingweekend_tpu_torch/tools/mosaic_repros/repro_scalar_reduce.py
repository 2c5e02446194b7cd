"""K12: min and max of a block reduced to scalars, a scalar scratch, and a
while loop on their span; the port of
tools/mosaic_repros/repro_scalar_reduce.py.

The kernel (csrc/mosaic_repros.cu) reduces the (8, 128) block with warp
shuffles and shared memory into one __shared__ scalar pair, then every
thread runs the repro's loop: trips = the least i with i * 13 >= max - min,
capped at 100. Rows 0..2 of the output hold min, max and trips; rows 3..7
are left unwritten, as the JAX kernel leaves them, so only rows 0..2 are
compared. The min and max are fminf / fmaxf, right for negative inputs
too.
"""
from __future__ import annotations

import torch

from ._common import LAUNCHES, launch, make_row, need_cuda

R, C = 8, 128
OUT_ROWS = 3           # the rows the kernel writes: min, max, trips
TRIP_STEP, TRIP_CAP = 13.0, 100
FORMS = ("scalar reduce",)
KERNEL_LAUNCHES = {"K12 scalar reduce": 0}


def repro_input(device="cpu") -> torch.Tensor:
    """The repro's x: arange(8 * 128) % 36 + 7, (8, 128) float32."""
    return (torch.arange(R * C, dtype=torch.float32, device=device)
            .reshape(R, C) % 36.0 + 7.0)


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] < 1 or x.shape[0] < OUT_ROWS or \
            x.dtype != torch.float32:
        raise ValueError(f"x must be float32 (rows >= {OUT_ROWS}, cols), "
                         f"got {x.dtype} {tuple(x.shape)}")


def scalar_reduce_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: rows 0..2 = min, max, trips (the loop's count:
    i * 13 is exact and grows with i, so it counts the i < 100 with
    i * 13 < span); rows 3.. uninitialised, as the kernel's."""
    _check(x)
    lo, hi = x.min(), x.max()
    span = hi - lo
    i = torch.arange(TRIP_CAP, dtype=torch.float32, device=x.device)
    trips = (i * TRIP_STEP < span).sum().float()
    out = torch.empty_like(x)
    out[0:OUT_ROWS] = torch.stack([lo, hi, trips])[:, None]
    return out


def scalar_reduce_kernel(x: torch.Tensor) -> torch.Tensor:
    """The kernel on the card: one block of 256 threads."""
    _check(x)
    need_cuda("K12", x)
    out = torch.empty_like(x)
    launch("K12", "rtw_repro_scalar_reduce_launch", x.data_ptr(),
           out.data_ptr(), x.numel(), x.shape[1], device=x.device)
    KERNEL_LAUNCHES["K12 scalar reduce"] += 1
    return out


def scalar_reduce(x: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    fn = scalar_reduce_kernel if x.is_cuda else scalar_reduce_reference
    return fn(x)


def run(device="cuda", launches: int = LAUNCHES, outputs=None) -> list:
    """The repro's input: one row; rows 0..2 compared."""
    x = repro_input(device)
    got = scalar_reduce(x)[0:OUT_ROWS]
    want = scalar_reduce_reference(x)[0:OUT_ROWS]
    if outputs is not None:
        outputs["K12 scalar reduce"] = (got, want)
    # the repro's answer: [7, 42, 3]
    expect = torch.tensor([7.0, 42.0, 3.0], device=got.device)
    # the work: read x once, write rows 0..2; a compare an element for
    # each of min and max
    return [make_row(
        "K12", FORMS[0], f"x ({R}, {C}) f32 -> rows 0..2 of ({R}, {C})",
        lambda: scalar_reduce(x), lambda: scalar_reduce_reference(x),
        device, launches, nbytes=4 * (R * C + OUT_ROWS * C),
        ops=2 * R * C, got=got, want=want,
        library=(None, "none: no one PyTorch call reduces and loops on the "
                 "span without reading it on the host"),
        as_expected=torch.equal(got[:, 0], expect)
        and bool((got == got[:, :1]).all()))]


def verdict(rows: list) -> list:
    return [f"scalar reduce: {'PASS' if r['as_expected'] else 'FAIL'} "
            "(rows 0..2 = [7, 42, 3] wanted)" for r in rows]
