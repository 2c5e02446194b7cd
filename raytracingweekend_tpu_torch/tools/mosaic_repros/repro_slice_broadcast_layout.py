"""K11: out (SB, T) = row (1, T) * col (SB, 1), written W lanes a chunk;
the port of tools/mosaic_repros/repro_slice_broadcast_layout.py.

On the TPU, slicing a register-held row at a lane offset >= 128 and
broadcasting it against the column failed Mosaic's layout check; the
megakernel re-loads each chunk's slice from the ref. On the H100 both are
kernels of csrc/mosaic_repros.cu: the register slice loads a thread's
lanes of the row once and slices them per chunk, the ref load re-reads
them inside each chunk. The chunk offset ch * W applies to load and store
alike; at the repro's T / W = 2 the second chunk starts at lane 256.
"""
from __future__ import annotations

import numpy as np
import torch

from ._common import LAUNCHES, launch, make_row, need_cuda, where

SB, T, W = 64, 512, 256
MAX_CHUNKS = 8
FORMS = ("register slice", "ref load")
KERNEL_LAUNCHES = {"K11 register slice": 0, "K11 ref load": 0}


def inputs(seed: int = 0, device="cpu") -> tuple:
    """The repro's row (1, T) and col (SB, 1): standard normals from
    numpy's default_rng(seed), drawn in that order, float32."""
    rng = np.random.default_rng(seed)
    row = rng.standard_normal((1, T)).astype(np.float32)
    col = rng.standard_normal((SB, 1)).astype(np.float32)
    return (torch.from_numpy(row).to(device),
            torch.from_numpy(col).to(device))


def _check(row: torch.Tensor, col: torch.Tensor, w: int) -> tuple:
    if row.dim() != 2 or row.shape[0] != 1 or col.dim() != 2 or \
            col.shape[1] != 1:
        raise ValueError(f"row (1, T) and col (SB, 1) expected, got "
                         f"{tuple(row.shape)} and {tuple(col.shape)}")
    if row.dtype != torch.float32 or col.dtype != torch.float32:
        raise ValueError("row and col must be float32")
    t = row.shape[1]
    if w < 1 or t % w or t // w > MAX_CHUNKS:
        raise ValueError(f"W={w} must divide T={t} into at most "
                         f"{MAX_CHUNKS} chunks")
    return col.shape[0], t


def slice_reference(row: torch.Tensor, col: torch.Tensor,
                    w: int = W) -> torch.Tensor:
    """The plain version of both forms: each chunk's row slice times the
    column."""
    _, t = _check(row, col, w)
    return torch.cat([row[:, ch:ch + w] * col for ch in range(0, t, w)],
                     dim=1)


def _slice_kernel(form: int, row, col, w: int) -> torch.Tensor:
    sb, t = _check(row, col, w)
    need_cuda("K11", row, col)
    out = torch.empty((sb, t), dtype=torch.float32, device=row.device)
    launch("K11", "rtw_repro_slice_launch", form, row.data_ptr(),
           col.data_ptr(), out.data_ptr(), sb, t, w, device=row.device)
    KERNEL_LAUNCHES[f"K11 {FORMS[form]}"] += 1
    return out


def reg_slice_kernel(row, col, w: int = W) -> torch.Tensor:
    """The register slice on the card: a thread's lanes of the row loaded
    once, then sliced per chunk."""
    return _slice_kernel(0, row, col, w)


def ref_load_kernel(row, col, w: int = W) -> torch.Tensor:
    """The ref load on the card: the chunk's lanes re-read in each chunk."""
    return _slice_kernel(1, row, col, w)


reg_slice_reference = slice_reference
ref_load_reference = slice_reference


def reg_slice(row, col, w: int = W):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    fn = reg_slice_kernel if row.is_cuda else reg_slice_reference
    return fn(row, col, w)


def ref_load(row, col, w: int = W):
    fn = ref_load_kernel if row.is_cuda else ref_load_reference
    return fn(row, col, w)


def run(device="cuda", launches: int = LAUNCHES, outputs=None) -> list:
    """Both forms at the repro's SB = 64, T = 512, W = 256 on its seed-0
    inputs: one row each."""
    row, col = inputs(0, device)
    want = slice_reference(row, col)
    # the repro's own answer: numpy's row * col
    expect = torch.from_numpy(row.cpu().numpy() * col.cpu().numpy())
    outs = [reg_slice(row, col), ref_load(row, col)]
    same = torch.equal(outs[0], outs[1])
    rows = []
    for name, fn, out in zip(FORMS, (reg_slice, ref_load), outs):
        if outputs is not None:
            outputs[f"K11 {name}"] = (out, want)
        # the work: read row and col once, write out; a multiply an element
        rows.append(make_row(
            "K11", name, f"row (1, {T}), col ({SB}, 1) -> ({SB}, {T}) f32, "
            f"W = {W}", lambda fn=fn: fn(row, col),
            lambda: slice_reference(row, col), device, launches,
            nbytes=4 * (T + SB + SB * T), ops=SB * T, got=out, want=want,
            library=(lambda: torch.mul(row, col), "torch.mul(row, col)"),
            forms_equal=same,
            as_expected=torch.equal(out.cpu(), expect)))
    return rows


def verdict(rows: list) -> list:
    lines = []
    by = {r["name"]: r for r in rows}
    if "ref load" in by:
        lines.append("ref-load per chunk: builds, exact" if
                     by["ref load"]["as_expected"] else
                     "ref-load variant is wrong")
    reg = by.get("register slice")
    if reg:
        lines.append(f"register-slice per chunk: builds and is exact "
                     f"{where(reg)}" if reg["as_expected"] else
                     f"register-slice: builds but WRONG {where(reg)}")
    return lines
