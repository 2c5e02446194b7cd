"""K12: min and max of a block reduced to scalars, a scalar scratch, and a
while loop on their span; the port of
tools/mosaic_repros/repro_scalar_reduce.py.

Rows 0..2 of the output hold min, max and trips = the least i in [0, 100]
with i * 13 >= max - min (the repro's loop: NaN gives 0, +inf 100); rows
3.. are left unwritten, as the JAX kernel leaves them, so only rows 0..2
are compared (`rows_equal`: NaN by position, every other element bit for
bit). The min and max are XLA's: NaN if any element is NaN, and of
signed zeros -0.0 the smaller (the min of +0.0 and -0.0 is -0.0, their
max +0.0).

On the card (csrc/mosaic_repros.cu) up to ONE_BLOCK elements take one
block, at the repro's (8, 128) one warp whose lanes issue all their
float4 loads at once; NaN-propagating PTX min / max, a butterfly shuffle
that leaves the pair in every lane, the pair written by one lane to a
__shared__ scratch and read back after __syncwarp (after one
__syncthreads where the block has several warps); the trip count in
closed form, ceil(span / 13) clamped and corrected by one against the
exact i * 13 comparison; rows 0..2 stored with no integer division,
float4s where the width allows. Past ONE_BLOCK elements a grid (at most
GRID_BLOCKS blocks) reduces grid-stride shares into per-call partials,
and the last block to take the atomic ticket combines them, counts the
trips and stores, in one launch with no host read. Indices are 64-bit:
every shape `_check` admits is read and written.
"""
from __future__ import annotations

import torch

from ._common import F32, LAUNCHES, Entry, make_row, refuse

R, C = 8, 128
OUT_ROWS = 3           # the rows the kernel writes: min, max, trips
TRIP_STEP, TRIP_CAP = 13.0, 100
ONE_BLOCK = 8192       # elements one block reduces; past it, the grid
GRID_BLOCKS = 2048     # the grid's most blocks: the slots of its partials
FORMS = ("scalar reduce",)
KERNEL_LAUNCHES = {"K12 scalar reduce": 0}
_KEY = "K12 scalar reduce"
_REDUCE = Entry("K12", "rtw_repro_scalar_reduce_launch", 4, KERNEL_LAUNCHES)
_REDUCE_GRID = Entry("K12", "rtw_repro_scalar_reduce_grid_launch", 6,
                     KERNEL_LAUNCHES)
# the F6 / F8 edge inputs (`edge_input`): NaN, infinities, signed zeros
EDGE_CASES = ("nan first", "nan middle", "nan last", "inf", "all inf",
              "+0 with -0 first", "+0 with -0 last", "-0 with +0 first",
              "-0 with +0 last", "all +0", "all -0")


def repro_input(device="cpu") -> torch.Tensor:
    """The repro's x: arange(8 * 128) % 36 + 7, (8, 128) float32."""
    return base_input(R, C, device)


def base_input(rows: int, cols: int, device="cpu") -> torch.Tensor:
    """The repro's x at any shape: arange(rows * cols) % 36 + 7."""
    return (torch.arange(rows * cols, dtype=F32, device=device)
            .reshape(rows, cols) % 36.0 + 7.0)


def edge_input(case: str, rows: int = R, cols: int = C,
               device="cpu") -> torch.Tensor:
    """An F6 / F8 edge input of shape (rows, cols) (`EDGE_CASES`): the
    repro's x with a NaN at the first element, at (3, 5) or at the last
    one; with -inf first and +inf last; all +inf (span NaN); all +0.0
    with one -0.0 first or last; all -0.0 with one +0.0 first or last;
    all +0.0; all -0.0."""
    if case not in EDGE_CASES:
        raise ValueError(f"no K12 edge input {case!r}")
    first, last = (0, 0), (rows - 1, cols - 1)
    spot = {"first": first, "middle": (min(3, rows - 1), min(5, cols - 1)),
            "last": last}
    if case.startswith("nan"):
        x = base_input(rows, cols, device)
        x[spot[case.split()[1]]] = float("nan")
    elif case == "inf":
        x = base_input(rows, cols, device)
        x[first], x[last] = float("-inf"), float("inf")
    elif case == "all inf":
        x = torch.full((rows, cols), float("inf"), device=device)
    elif case in ("all +0", "all -0"):
        x = torch.full((rows, cols), -0.0 if "-" in case else 0.0,
                       device=device)
    else:
        fill, _, other, where = case.split()
        x = torch.full((rows, cols), float(fill), device=device)
        x[spot[where]] = float(other)
    return x


def _check(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] < 1 or x.shape[0] < OUT_ROWS or \
            x.dtype != torch.float32:
        raise ValueError(f"x must be float32 (rows >= {OUT_ROWS}, cols), "
                         f"got {x.dtype} {tuple(x.shape)}")


def _extremes(x: torch.Tensor) -> tuple:
    """x's min and max in XLA's order: NaN if any element is NaN; a zero
    min is -0.0 where any element is -0.0, a zero max +0.0 where any
    element is +0.0 (torch's min and max return either zero)."""
    lo, hi = x.min(), x.max()
    zero, neg = x == 0, torch.signbit(x)
    z = torch.zeros_like(lo)
    lo = torch.where(lo == 0, torch.where((zero & neg).any(), -z, z), lo)
    hi = torch.where(hi == 0, torch.where((zero & ~neg).any(), z, -z), hi)
    return lo, hi


def scalar_reduce_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: rows 0..2 = min, max (`_extremes`), trips (the
    loop's count: i * 13 is exact and grows with i, so it counts the
    i < 100 with i * 13 < span); rows 3.. uninitialised, as the
    kernel's."""
    _check(x)
    lo, hi = _extremes(x)
    span = hi - lo
    i = torch.arange(TRIP_CAP, dtype=torch.float32, device=x.device)
    trips = (i * TRIP_STEP < span).sum().float()
    out = torch.empty_like(x)
    out[0:OUT_ROWS] = torch.stack([lo, hi, trips])[:, None]
    return out


def rows_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Rows 0..2 of two outputs agree: NaN at the same places (a NaN's
    payload and sign are not compared: torch's NaN has its sign bit set,
    JAX's and the kernel's not), every other element bit for bit, so a
    -0.0 never equals a +0.0."""
    g, w = got[:OUT_ROWS].contiguous(), want[:OUT_ROWS].contiguous()
    gn, wn = g.isnan(), w.isnan()
    zero = torch.zeros((), dtype=torch.int32, device=g.device)
    return (g.shape == w.shape and torch.equal(gn, wn) and torch.equal(
        torch.where(gn, zero, g.view(torch.int32)),
        torch.where(wn, zero, w.view(torch.int32))))


def scalar_reduce_kernel(x: torch.Tensor) -> torch.Tensor:
    """The kernel on the card: one block up to ONE_BLOCK elements (one
    warp at the repro's shape), else the grid with its partials and ticket
    allocated for this call."""
    xs, dev = x.shape, x.get_device()
    if not (dev >= 0 and x.dtype is F32 and len(xs) == 2
            and xs[0] >= OUT_ROWS and xs[1] >= 1 and x.is_contiguous()):
        _check(x)
        refuse("K12", x)
    out = x.new_empty(xs)
    n = xs[0] * xs[1]
    if n <= ONE_BLOCK:
        _REDUCE.launch(_KEY, dev, x.data_ptr(), out.data_ptr(), n, xs[1])
    else:
        work = x.new_empty(2 * GRID_BLOCKS + 1)
        _REDUCE_GRID.launch(_KEY, dev, x.data_ptr(), out.data_ptr(), n,
                            xs[1], work.data_ptr(), GRID_BLOCKS)
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
