"""Microbenchmark of the megakernel's small linear-algebra formulations:
kernel K9 and its plain versions.

The port of tools/dot_microbench.py. Each row times N dependency-chained
steps acc = f(acc) of one body on an (S, T) float32 accumulator, in one
launch of csrc/dot_microbench.cu, at N and 4N steps; the cost of a step is
the slope between the best launch times of the two (best of --reps). The
bodies, from the tool (:107-205):

  lane16   acc = mx (S, 16) @ (acc[0:16] * 1e-30 + 1)
  sub16    the same with the matrix stored (16, S)
  extract  acc = acc * 0.5 + pad(at (24, S) @ (acc == 0)), the attribute
           extraction's one-hot shape, padded back to (S, T)
  elemq    the ~25-op elementwise moving-sphere quadratic
  minmask  acc = acc + (acc == its column min)

Precision: the TPU's "f32 default" (one reduced-precision MXU pass) is the
H100's TF32 tensor cores (inputs rounded to TF32, round to nearest with
ties away from zero, as __float_to_tf32); "f32 HIGHEST" is exact FP32 on
the FMA pipes, every multiply-add an fmaf; "bf16" is the BF16 tensor
cores with float32 accumulation. Rows keep the tool's names and add
`h100_unit` (tf32, fp32 or bf16).

    python -m raytracingweekend_tpu_torch.tools.dot_microbench [--S 512]
        [--T 2048] [--iters 64] [--reps 5] [--device cuda|cpu]
        [--json rows.jsonl]

One JSON row a measurement goes to stdout (and to --json when given): µs
a step, the operations a step and their rate, the bound a step (the
operations over the unit's peak), and for lane16, sub16 and extract the
same slope of one `torch.matmul` of the step's product a step (TF32 on for
"default", off for "HIGHEST", bf16 tensors for bf16): a yardstick only,
never the kernel. The default device is `cuda` and raises without a card;
`--device cpu` times the plain versions (tiny sizes only).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import sys

import numpy as np
import torch

from . import card_line, time_ms
from ..ops import _build
from ..ops.megakernel import _sqrt
from ..ops.rounding import _fma

BODIES = ("lane16", "sub16", "extract", "elemq", "minmask")
UNITS = ("fp32", "tf32", "bf16")
# the tool's rows, in its order: (name, body, H100 unit)
ROWS = (("lane16 f32 default", "lane16", "tf32"),
        ("lane16 f32 HIGHEST", "lane16", "fp32"),
        ("sub16 f32 default", "sub16", "tf32"),
        ("sub16 f32 HIGHEST", "sub16", "fp32"),
        ("extract f32 default", "extract", "tf32"),
        ("extract f32 HIGHEST", "extract", "fp32"),
        ("extract bf16", "extract", "bf16"),
        ("elemq ~25 VPU ops", "elemq", "fp32"),
        ("min+eqmask", "minmask", "fp32"))
A_ROWS = 24
COLS = 8       # accumulator columns a block owns (T % COLS == 0)
S_ALIGN = 64   # S % 64 == 0: a thread's rows g + 64 i
WARPS = 16     # warps a block: the FP32 extract's row chunks
# H100 SXM peaks (dense), FLOP/s
PEAK = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
# FP32 operations a (row, column) element of a step: elemq's frac 2,
# moving centre 6, oc 3, b 5, cc 6, disc 2, sqrt 1, the two roots 3 (the
# ray from acc[0] is per column); minmask's min, compare and add
OPS_ELEMQ = 28
OPS_MINMASK = 3

# CUDA kernel launches through `microbench_kernel` in this process
KERNEL_LAUNCHES = {"K9": 0}


def make_tables(S: int, seed: int = 0) -> dict:
    """The tool's inputs, drawn in its order from numpy's default_rng(seed):
    mx (S, 16), mxt (16, S), at (24, S), sph (S, 128), float32."""
    rng = np.random.default_rng(seed)
    shapes = (("mx", (S, 16)), ("mxt", (16, S)), ("at", (A_ROWS, S)),
              ("sph", (S, 128)))
    return {k: rng.normal(size=shape).astype(np.float32)
            for k, shape in shapes}


def table_for(body: str, unit: str, tables: dict, device) -> torch.Tensor:
    """The tensor a body reads: mx, mxt, at (bfloat16 for bf16, as the tool
    converts it) or sph (minmask reads none; the tool passes sph)."""
    name = {"lane16": "mx", "sub16": "mxt", "extract": "at"}.get(body, "sph")
    t = torch.from_numpy(tables[name]).to(device)
    return t.to(torch.bfloat16) if unit == "bf16" else t


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as CUDA's __float_to_tf32 (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _check_pair(body: str, unit: str) -> None:
    if body not in BODIES or unit not in UNITS:
        raise ValueError(f"body {body!r} / unit {unit!r}: bodies {BODIES}, "
                         f"units {UNITS}")
    if (body in ("lane16", "sub16") and unit == "bf16") or (
            body in ("elemq", "minmask") and unit != "fp32"):
        raise ValueError(f"{body} has no {unit} row")


def _product(a: torch.Tensor, b: torch.Tensor, unit: str) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the tensor cores take it: inputs at the
    unit's precision (TF32: rounded here; bf16: given), the sum exact, then
    rounded once to float32."""
    if unit == "tf32":
        a, b = round_tf32(a.float()), round_tf32(b.float())
    return (a.double() @ b.double()).float()


def _step(body: str, unit: str, a: torch.Tensor,
          tab: torch.Tensor) -> torch.Tensor:
    """One step of a body on the (S, T) accumulator, the kernel's
    arithmetic: FP32 multiply-adds as single-rounding FMAs in the kernel's
    order, tensor-core products as `_product`."""
    S, T = a.shape
    if body in ("lane16", "sub16"):
        m = tab if body == "lane16" else tab.t()              # (S, 16)
        rhs = _fma(a[0:16], 1e-30, 1.0)                       # (16, T)
        if unit != "fp32":
            return _product(m, rhs, unit)
        out = torch.zeros_like(a)
        for k in range(16):
            out = _fma(m[:, k:k + 1], rhs[k:k + 1], out)
        return out
    if body == "extract":
        mask = (a == 0.0).float()
        if unit == "fp32":
            # the kernel's order: each warp's S / WARPS rows in row order,
            # then the warps' sums in warp order; at * mask is exact, so
            # each add is the kernel's fmaf or add
            span = S // WARPS
            r = None
            for w0 in range(0, S, span):
                q = torch.zeros((A_ROWS, T), dtype=torch.float32,
                                device=a.device)
                for s in range(w0, w0 + span):
                    q = q + tab[:, s:s + 1] * mask[s:s + 1]
                r = q if r is None else r + q
        else:
            r = _product(tab, mask.to(tab.dtype), unit)
        pad = torch.zeros_like(a)
        pad[:A_ROWS] = r
        return _fma(a, 0.5, pad)
    if body == "elemq":
        col = [tab[:, k:k + 1] for k in range(9)]             # (S, 1) each
        ox = _fma(a[0:1], 1e-30, 1.0)                         # (1, T)
        oy, oz = ox, ox
        dx = ox * 0.5
        dy, dz = dx, dx
        tmv = ox * 0.1
        frac = (tmv - col[6]) * col[7]
        cx = _fma(frac, col[3], col[0])
        cy = _fma(frac, col[4], col[1])
        cz = _fma(frac, col[5], col[2])
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = _fma(ocz, dz, _fma(ocx, dx, ocy * dy))
        cc = _fma(ocz, ocz, _fma(ocx, ocx, ocy * ocy)) - col[8]
        disc = _fma(b, b, -cc)
        sq = _sqrt(disc)
        tn = -b - sq
        tc = torch.where(tn > 1e-3, tn, -b + sq)
        return torch.where(tc > 1e-3, tc, torch.full_like(tc, 3e37))
    m = a.min(dim=0, keepdim=True).values                     # minmask
    return a + (a == m).float()


def microbench_reference(body: str, unit: str, tab: torch.Tensor, S: int,
                         T: int, n: int) -> torch.Tensor:
    """The plain version: n steps from the tool's initial accumulator
    (ones for minmask, else zeros); returns its rows 0..7, (8, T)."""
    _check_pair(body, unit)
    a = torch.full((S, T), 1.0 if body == "minmask" else 0.0,
                   dtype=torch.float32, device=tab.device)
    for _ in range(n):
        a = _step(body, unit, a, tab)
    return a[0:8].clone()


def _expected_table(body: str, unit: str, S: int) -> tuple:
    if body == "lane16":
        return (S, 16), torch.float32
    if body == "sub16":
        return (16, S), torch.float32
    if body == "extract":
        return (A_ROWS, S), (torch.bfloat16 if unit == "bf16"
                             else torch.float32)
    return (S, 128), torch.float32


def microbench_kernel(body: str, unit: str, tab: torch.Tensor, S: int, T: int,
                      n: int, lib=None) -> torch.Tensor:
    """Launch csrc/dot_microbench.cu on the current CUDA stream. Same
    arguments and result as `microbench_reference`; S % 64 == 0 and
    T % 8 == 0. `lib` is another build of the kernel with the same C
    interface (a measurement build). Raises on a CPU tensor, a wrong shape
    or dtype, a failed build and a refused launch."""
    _check_pair(body, unit)
    if not tab.is_cuda:
        raise ValueError(f"microbench_kernel needs a CUDA tensor; the table "
                         f"is on {tab.device}")
    shape, dtype = _expected_table(body, unit, S)
    if tab.dtype != dtype or tuple(tab.shape) != shape:
        raise ValueError(f"{body} table: expected {dtype} {shape}, got "
                         f"{tab.dtype} {tuple(tab.shape)}")
    if S < S_ALIGN or S % S_ALIGN or T < COLS or T % COLS or n < 0:
        raise ValueError(f"S={S} must be a multiple of {S_ALIGN}, T={T} of "
                         f"{COLS}, n={n} >= 0")
    tab = tab.contiguous()
    out = torch.empty((8, T), dtype=torch.float32, device=tab.device)
    lib = lib or _kernel_lib()
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rtw_microbench_launch(BODIES.index(body), UNITS.index(unit),
                                       tab.data_ptr(), out.data_ptr(), S, T,
                                       n, stream)
    if rc != 0:
        raise RuntimeError(f"K9 launch failed: CUDA error {rc} "
                           f"({lib.rtw_error_string(rc).decode()})")
    KERNEL_LAUNCHES["K9"] += 1
    return out


def microbench(body, unit, tab, S, T, n):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    fn = microbench_kernel if tab.is_cuda else microbench_reference
    return fn(body, unit, tab, S, T, n)


def plain_tolerance(body: str, tab: torch.Tensor) -> torch.Tensor:
    """How far the kernel's rows 0..7 may lie from the plain version's, per
    row, (8, 1): both take the same (rounded) inputs, so a product's sum
    differs only in its order, by at most (terms + 2) 2^-24 of the sum of
    the absolute terms (here bounded by the row's |A| @ 1, the other
    factor being 1 or a 0/1 mask), twice that for extract, whose steps
    halve the accumulator and add a new sum; the elementwise bodies match
    bit for bit."""
    if body not in ("lane16", "sub16", "extract"):
        return torch.zeros((8, 1), dtype=torch.float32, device=tab.device)
    m = (tab if body != "sub16" else tab.t()).float()
    grow = 2.0 if body == "extract" else 1.0
    return (grow * (m.shape[1] + 2) * 2.0 ** -24
            * m[0:8].abs().sum(dim=1, keepdim=True))


def ops_per_step(body: str, unit: str, S: int, T: int) -> dict:
    """Operations of one step by the unit that does them: the product's
    flops on `unit`, the elementwise work on fp32."""
    if body in ("lane16", "sub16"):
        product, elementwise = 2 * S * 16 * T, 2 * 16 * T
    elif body == "extract":
        product, elementwise = 2 * A_ROWS * S * T, 3 * S * T
    elif body == "elemq":
        product, elementwise = 0, OPS_ELEMQ * S * T + 4 * T
    else:
        product, elementwise = 0, OPS_MINMASK * S * T
    ops = {"fp32": elementwise}
    if product:
        ops[unit] = ops.get(unit, 0) + product
    return ops


def bound_us(body: str, unit: str, S: int, T: int) -> float:
    """Least time of one step on an H100: each unit's operations over its
    peak, the slowest unit bounding (the accumulator stays on chip, so
    bytes do not)."""
    return max(v / PEAK[k] for k, v in ops_per_step(body, unit, S,
                                                    T).items()) * 1e6


@contextlib.contextmanager
def _matmul_tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def library_product(body: str, unit: str, tab: torch.Tensor, S: int,
                    T: int):
    """A callable running one `torch.matmul` of the step's product, and
    the TF32 setting it is timed under; None for elemq and minmask."""
    dev = tab.device
    if body in ("lane16", "sub16"):
        m = tab if body == "lane16" else tab.t()
        rhs = torch.ones((16, T), dtype=torch.float32, device=dev)
        return (lambda: torch.matmul(m, rhs)), unit == "tf32"
    if body == "extract":
        mask = torch.ones((S, T), dtype=tab.dtype, device=dev)
        return (lambda: torch.matmul(tab, mask)), unit == "tf32"
    return None


def _slope_us(fn_n, n: int, reps: int, device) -> float:
    """µs a step: the slope between the best times of fn_n(n) and
    fn_n(4 n), best of `reps` each after a warm-up of both."""
    best = {}
    for k in (n, 4 * n):
        fn_n(k)
    for _ in range(max(1, reps)):
        for k in (n, 4 * n):
            ms, _ = time_ms(lambda: fn_n(k), device)
            best[k] = min(best.get(k, ms), ms)
    return (best[4 * n] - best[n]) / (3 * n) * 1e3


def run(S: int = 512, T: int = 2048, N: int = 64, reps: int = 5,
        device="cuda") -> list:
    """Time every row of the tool at (S, T): one dict a row (see the
    module docstring)."""
    device = torch.device(device)
    where = card_line(device.type)
    if N < 1:
        raise ValueError(f"N={N} must be >= 1")
    tables = make_tables(S)
    rows = []
    for name, body, unit in ROWS:
        tab = table_for(body, unit, tables, device)
        per = _slope_us(lambda k: microbench(body, unit, tab, S, T, k), N,
                        reps, device)
        ops = sum(ops_per_step(body, unit, S, T).values())
        lib_us = None
        lib = library_product(body, unit, tab, S, T)
        if lib is not None:
            product, tf32 = lib

            def matmuls(k):
                for _ in range(k):
                    out = product()
                return out

            with _matmul_tf32(tf32):
                lib_us = _slope_us(matmuls, N, reps, device)
        rows.append({"name": name, "h100_unit": unit, "S": S, "T": T,
                     "iters": [N, 4 * N], "us_per_iter": per,
                     "ops_per_iter": ops,
                     "ops_per_s": ops / (per * 1e-6) if per > 0 else None,
                     "bound_us_per_iter": bound_us(body, unit, S, T),
                     "library_us_per_iter": lib_us, "device": where})
    return rows


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set K9's argtypes on a kernel library (the shipped build or a
    measurement build)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rtw_microbench_launch.argtypes = [i, i, p, p, i, i, i, p]
    lib.rtw_microbench_launch.restype = ctypes.c_int
    lib.rtw_error_string.argtypes = [ctypes.c_int]
    lib.rtw_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    """The built kernel library (ops/_build.py) with K9's argtypes."""
    return bind(_build.load())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--S", type=int, default=512)
    ap.add_argument("--T", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default="",
                    help="append one JSON line per measurement here")
    args = ap.parse_args(argv)
    rows = run(args.S, args.T, args.iters, args.reps, args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
