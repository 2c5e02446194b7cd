"""K10: a row-index iota (ROWS, T) built as float32 directly and as int32
then cast; the port of tools/mosaic_repros/repro_f32_iota.py.

On the TPU the float iota failed Mosaic's verifier (`tpu.iota` takes
integers only) and the megakernel builds an int iota and casts. On the
H100 both forms are kernels of csrc/mosaic_repros.cu over a grid of
column blocks and runs of rows, a float4 store a thread a row where the
width is a multiple of 4: the f32 iota makes a run's first value from the
row's bits (an OR and an FADD) and adds 1.0f a row, with no conversion;
the int iota converts the row index with __int2float_rn (an I2F
instruction). Both must be exact, and write every element of every shape
`_check` admits (the grid and its indices are 64-bit).

The kernels take no input tensor; a wrapper resolves its device argument
once per value (`_target`: an empty float32 tensor there, which the output
is allocated from with `new_empty`, and its index).
"""
from __future__ import annotations

import torch

from ._common import F32, FP32_PEAK, LAUNCHES, Entry, make_row, where

ROWS, T = 24, 256
FORMS = ("f32 iota", "int iota + cast")
KERNEL_LAUNCHES = {"K10 f32 iota": 0, "K10 int iota + cast": 0}
_KEYS = tuple(KERNEL_LAUNCHES)
_IOTA = Entry("K10", "rtw_repro_iota_launch", 4, KERNEL_LAUNCHES)
MAX_ROWS = 1 << 24            # float32 counts every row index exactly
_TARGETS = {}                 # device argument -> (empty tensor, index)


def _check(rows: int, cols: int) -> None:
    if rows < 1 or cols < 1 or rows > MAX_ROWS:
        raise ValueError(f"iota of shape ({rows}, {cols}): rows in [1, "
                         "2^24] (float32 counts exactly), cols >= 1")


def iota_reference(rows: int = ROWS, cols: int = T, device="cpu"):
    """The plain version of both forms: torch.arange rows, broadcast."""
    _check(rows, cols)
    col = torch.arange(rows, dtype=torch.float32, device=device)[:, None]
    return col.expand(rows, cols).contiguous()


def _target(device) -> tuple:
    """(an empty float32 tensor on CUDA device `device`, its index),
    resolved at the first call with this argument; a device with no index
    ("cuda") is kept only on a machine of one card, where it always names
    that card. Raises ValueError for a device that is not CUDA."""
    hit = _TARGETS.get(device)
    if hit is None:
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the K10 kernels run on a CUDA device, not "
                             f"{device}")
        empty = torch.empty(0, dtype=F32, device=dev)
        hit = (empty, empty.get_device())
        if dev.index is not None or torch.cuda.device_count() == 1:
            _TARGETS[device] = hit
    return hit


def _iota_kernel(form: int, rows: int, cols: int, device) -> torch.Tensor:
    if not (0 < rows <= MAX_ROWS and cols > 0):
        _check(rows, cols)
    empty, index = _target(device)
    out = empty.new_empty((rows, cols))
    _IOTA.launch(_KEYS[form], index, form, out.data_ptr(), rows, cols)
    return out


def f32_iota_kernel(rows: int = ROWS, cols: int = T, device="cuda"):
    """The float iota on the card: a run's first row from its bits, then
    1.0f added a row."""
    return _iota_kernel(0, rows, cols, device)


def int_iota_cast_kernel(rows: int = ROWS, cols: int = T, device="cuda"):
    """The int iota cast to float32 on the card (__int2float_rn)."""
    return _iota_kernel(1, rows, cols, device)


f32_iota_reference = iota_reference
int_iota_cast_reference = iota_reference


def _on_cuda(device) -> bool:
    return device in _TARGETS or torch.device(device).type == "cuda"


def f32_iota(rows: int = ROWS, cols: int = T, device="cuda"):
    """The kernel on a CUDA device, the plain version on the CPU."""
    fn = f32_iota_kernel if _on_cuda(device) else f32_iota_reference
    return fn(rows, cols, device)


def int_iota_cast(rows: int = ROWS, cols: int = T, device="cuda"):
    fn = int_iota_cast_kernel if _on_cuda(device) else \
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
