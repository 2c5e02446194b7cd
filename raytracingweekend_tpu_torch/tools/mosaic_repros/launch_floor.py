"""The launch floor of the repro kernels: an empty kernel of one warp
(csrc/mosaic_repros.cu::repro_empty_kernel) launched through the
repros' launcher (`_common.Entry`).

It replaces no TPU kernel. What one launch of it costs, on the host and on
the device, is what any launch of K10-K14 costs before its body runs: the
floor their rows are read against. Card only.
"""
from __future__ import annotations

import torch

from ._common import LAUNCHES, Entry, launch_us

KERNEL_LAUNCHES = {"empty": 0}
_EMPTY = Entry("the empty kernel", "rtw_repro_empty_launch", 0,
               KERNEL_LAUNCHES)


def empty_kernel(dev: int = 0) -> None:
    """One launch of the empty kernel on the current stream of CUDA device
    index `dev`."""
    _EMPTY.launch("empty", dev)


def run(device="cuda", launches: int = LAUNCHES) -> float:
    """µs a launch of the empty kernel on `device`: the CUDA-event mean of
    `launches` launches in a row, as the repros' rows take theirs."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the launch floor is measured on a CUDA device, "
                         f"not {device}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return launch_us(lambda: empty_kernel(index), dev, launches)
