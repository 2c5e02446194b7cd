"""K14: (S, 3) x (3, T) at default precision, with the left operand lanes
0..2 of an (S, 128) table (the sub-slice form) or a dense (S, 3) input;
the port of tools/mosaic_repros/repro_dot_k3_subslice.py.

On the TPU the sub-slice form "picked up neighbouring lanes". Default
precision on the H100 is the TF32 tensor cores, as the port's
dot-formulation microbenchmark maps the TPU's "f32 default": both forms
are wmma m16n16k8 with float32 accumulation, K padded from 3 to 8 with
zeros, one warp a 16 x 16 tile (csrc/mosaic_repros.cu). The sub-slice form
reads the table with leading dimension 128 and zeroes lanes 3..7 before
the fragment load; the repro's table has nonzero lanes there, so a kernel
that read them would fail.

The plain versions round the inputs to TF32 (`dot_microbench.round_tf32`,
as __float_to_tf32) and sum the three products in float32: products of
TF32 inputs are exact in float32, so kernel and plain version differ only
in how the three-term sum is rounded, at most 2 ulp of sum |a| |b|
(`tolerance`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..dot_microbench import _matmul_tf32, round_tf32
from ._common import LAUNCHES, TF32_PEAK, launch, make_row, need_cuda

S, T, LANES, K = 64, 256, 128, 3
K_PAD = 8              # wmma's depth for TF32
TILE = 16
FORMS = ("subslice", "dense")
KERNEL_LAUNCHES = {"K14 subslice": 0, "K14 dense": 0}


def inputs(seed: int = 0, device="cpu") -> tuple:
    """tab (S, 128) and rays (3, T): standard normals from numpy's
    default_rng(seed), in that order, float32 (the repro draws normals from
    jax.random.key(0))."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((S, LANES)).astype(np.float32)
    rays = rng.standard_normal((K, T)).astype(np.float32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(rays).to(device))


def _check(lhs: torch.Tensor, rays: torch.Tensor, width: int) -> None:
    if lhs.dtype != torch.float32 or rays.dtype != torch.float32:
        raise ValueError("K14 takes float32 operands")
    if lhs.dim() != 2 or lhs.shape[1] != width or rays.dim() != 2 or \
            rays.shape[0] != K:
        raise ValueError(f"lhs (S, {width}) and rays ({K}, T) expected, got "
                         f"{tuple(lhs.shape)} and {tuple(rays.shape)}")


def _product(a: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """(S, 3) x (3, T) with TF32 inputs, the three products summed in
    float32 in k order."""
    a, b = round_tf32(a), round_tf32(rays)
    return (a[:, 0:1] * b[0:1] + a[:, 1:2] * b[1:2]) + a[:, 2:3] * b[2:3]


def subslice_reference(tab: torch.Tensor, rays: torch.Tensor):
    """The sub-slice form's plain version: lanes 0..2 of the table."""
    _check(tab, rays, LANES)
    return _product(tab[:, 0:K], rays)


def dense_reference(lhs: torch.Tensor, rays: torch.Tensor):
    """The dense form's plain version."""
    _check(lhs, rays, K)
    return _product(lhs, rays)


def _dot_kernel(form: int, lhs, rays, width: int) -> torch.Tensor:
    _check(lhs, rays, width)
    need_cuda("K14", lhs, rays)
    s, t = lhs.shape[0], rays.shape[1]
    if s % TILE or t % TILE:
        raise ValueError(f"S={s} and T={t} must be multiples of {TILE}")
    out = torch.empty((s, t), dtype=torch.float32, device=lhs.device)
    launch("K14", "rtw_repro_dot_k3_launch", form, lhs.data_ptr(),
           rays.data_ptr(), out.data_ptr(), s, t, device=lhs.device)
    KERNEL_LAUNCHES[f"K14 {FORMS[form]}"] += 1
    return out


def subslice_kernel(tab, rays) -> torch.Tensor:
    """The sub-slice form on the card: the (S, 128) table read with leading
    dimension 128, lanes 3..7 zeroed."""
    return _dot_kernel(0, tab, rays, LANES)


def dense_kernel(lhs, rays) -> torch.Tensor:
    """The dense form on the card: an (S, 3) input."""
    return _dot_kernel(1, lhs, rays, K)


def subslice(tab, rays):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    return (subslice_kernel if tab.is_cuda else subslice_reference)(tab,
                                                                    rays)


def dense(lhs, rays):
    return (dense_kernel if lhs.is_cuda else dense_reference)(lhs, rays)


def tolerance(lhs: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """2 ulp (float32) of sum over k of |a_k| |b_k| (TF32 inputs), per
    output element: how far the kernel's rounding of the three-term sum
    may lie from the plain version's."""
    a, b = round_tf32(lhs[:, 0:K]).abs(), round_tf32(rays).abs()
    mag = (a[:, 0:1] * b[0:1] + a[:, 1:2] * b[1:2]) + a[:, 2:3] * b[2:3]
    _, e = torch.frexp(mag)
    return torch.where(mag > 0, torch.ldexp(torch.ones_like(mag),
                                            (e - 23).float()),
                       torch.zeros_like(mag))


def library(tab, rays):
    """One torch.matmul of the sub-slice's product, TF32 allowed."""
    def call():
        with _matmul_tf32(True):
            return torch.matmul(tab[:, 0:K], rays)
    return call


def run(device="cuda", launches: int = LAUNCHES, outputs=None) -> list:
    """Both forms at the repro's S = 64, T = 256 on seed-0 tables: one row
    each; `as_expected` holds each within the plain version's tolerance of
    the float64 product of the unrounded inputs plus TF32's input rounding
    (3 2^-11 sum |a| |b|)."""
    tab, rays = inputs(0, device)
    lhs = tab[:, 0:K].contiguous()
    want = subslice_reference(tab, rays)
    tol = tolerance(tab, rays)
    exact = (tab[:, 0:K].double() @ rays.double())
    slack = 3 * 2.0 ** -11 * (tab[:, 0:K].double().abs()
                              @ rays.double().abs())
    outs = [subslice(tab, rays), dense(lhs, rays)]
    same = torch.equal(outs[0], outs[1])
    rows = []
    for name, fn, arg, out in zip(FORMS, (subslice, dense), (tab, lhs),
                                  outs):
        if outputs is not None:
            outputs[f"K14 {name}"] = (out, want)
        # the work: lanes 0..2 of the table, rays and out once; the product
        # padded to depth 8 on the TF32 tensor cores
        rows.append(make_row(
            "K14", name, f"{'tab' if name == 'subslice' else 'lhs'} "
            f"({S}, {arg.shape[1]}), rays ({K}, {T}) -> ({S}, {T}) f32, "
            "TF32", lambda fn=fn, arg=arg: fn(arg, rays),
            lambda name=name, arg=arg: (subslice_reference if name ==
                                        "subslice" else dense_reference)(
                arg, rays), device, launches,
            nbytes=4 * (S * K + K * T + S * T), ops=2 * S * K_PAD * T,
            peak=TF32_PEAK, got=out, want=want, tol=tol,
            library=(library(tab, rays),
                     "torch.matmul(tab[:, 0:3], rays), allow_tf32"),
            forms_equal=same,
            as_expected=bool(torch.all((out.double() - exact).abs()
                                       <= slack))))
    return rows


def verdict(rows: list) -> list:
    return [f"{r['name']}-LHS max err against the plain version: "
            f"{r['max_abs_err']:.3e} ("
            f"{'within' if r['agrees'] else 'OUTSIDE'} 2 ulp of "
            "sum |a||b|)" for r in rows]
