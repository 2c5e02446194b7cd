"""K10: a row-index iota (ROWS, T) built as float32 directly and as int32
then cast; the port of tools/mosaic_repros/repro_f32_iota.py.

On the TPU the float iota failed Mosaic's verifier (`tpu.iota` takes
integers only) and the megakernel builds an int iota and casts. On the
H100 both forms are kernels of csrc/mosaic_repros.cu: the f32 iota adds
1.0f a row with no conversion, the int iota converts the row index with
__int2float_rn (an I2F instruction). Both must be exact.
"""
from __future__ import annotations

import torch

from ._common import FP32_PEAK, LAUNCHES, Entry, make_row, where

ROWS, T = 24, 256
FORMS = ("f32 iota", "int iota + cast")
KERNEL_LAUNCHES = {"K10 f32 iota": 0, "K10 int iota + cast": 0}
_KEYS = tuple(KERNEL_LAUNCHES)
_IOTA = Entry("K10", "rtw_repro_iota_launch", 4, KERNEL_LAUNCHES)


def _check(rows: int, cols: int) -> None:
    if rows < 1 or cols < 1 or rows > 1 << 24:
        raise ValueError(f"iota of shape ({rows}, {cols}): rows in [1, "
                         "2^24] (float32 counts exactly), cols >= 1")


def iota_reference(rows: int = ROWS, cols: int = T, device="cpu"):
    """The plain version of both forms: torch.arange rows, broadcast."""
    _check(rows, cols)
    col = torch.arange(rows, dtype=torch.float32, device=device)[:, None]
    return col.expand(rows, cols).contiguous()


def _iota_kernel(form: int, rows: int, cols: int, device) -> torch.Tensor:
    _check(rows, cols)
    if torch.device(device).type != "cuda":
        raise ValueError(f"the K10 kernels run on a CUDA device, not "
                         f"{device}")
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    _IOTA.launch(_KEYS[form], out.get_device(), form, out.data_ptr(), rows,
                 cols)
    return out


def f32_iota_kernel(rows: int = ROWS, cols: int = T, device="cuda"):
    """The float iota on the card: each thread walks its column's rows,
    adding 1.0f."""
    return _iota_kernel(0, rows, cols, device)


def int_iota_cast_kernel(rows: int = ROWS, cols: int = T, device="cuda"):
    """The int iota cast to float32 on the card (__int2float_rn)."""
    return _iota_kernel(1, rows, cols, device)


f32_iota_reference = iota_reference
int_iota_cast_reference = iota_reference


def f32_iota(rows: int = ROWS, cols: int = T, device="cuda"):
    """The kernel on a CUDA device, the plain version on the CPU."""
    fn = f32_iota_kernel if torch.device(device).type == "cuda" else \
        f32_iota_reference
    return fn(rows, cols, device)


def int_iota_cast(rows: int = ROWS, cols: int = T, device="cuda"):
    fn = int_iota_cast_kernel if torch.device(device).type == "cuda" else \
        int_iota_cast_reference
    return fn(rows, cols, device)


def run(device="cuda", launches: int = LAUNCHES, outputs=None) -> list:
    """Both forms at the repro's (24, 256): one row each (see
    `_common.make_row`); `outputs`, a dict, gets each form's (output, plain
    output)."""
    want = iota_reference(ROWS, T, device)
    outs = [f32_iota(ROWS, T, device), int_iota_cast(ROWS, T, device)]
    same = torch.equal(outs[0], outs[1])
    rows = []
    for name, fn, out in zip(FORMS, (f32_iota, int_iota_cast), outs):
        if outputs is not None:
            outputs[f"K10 {name}"] = (out, want)
        # the work: write ROWS x T floats, one add or conversion each
        rows.append(make_row(
            "K10", name, f"out ({ROWS}, {T}) f32",
            lambda fn=fn: fn(ROWS, T, device),
            lambda: iota_reference(ROWS, T, device), device, launches,
            nbytes=4 * ROWS * T, ops=ROWS * T, got=out, want=want,
            peak=FP32_PEAK,
            library=(None, "none: no one PyTorch call makes the (24, 256) "
                     "row iota"),
            forms_equal=same, as_expected=torch.equal(out, want)))
    return rows


def verdict(rows: list) -> list:
    """The repro's words for what the card did."""
    lines = []
    by = {r["name"]: r for r in rows}
    cast = by.get("int iota + cast")
    if cast:
        lines.append("int32 iota + astype(f32): builds, exact" if
                     cast["as_expected"] else
                     "int-iota+cast variant is wrong")
    f32 = by.get("f32 iota")
    if f32:
        lines.append(f"f32 iota: builds and is exact {where(f32)}" if
                     f32["as_expected"] else
                     f"f32 iota: builds but WRONG {where(f32)}")
    return lines
