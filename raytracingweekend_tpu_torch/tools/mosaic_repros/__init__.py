"""The Mosaic repros (tools/mosaic_repros/ of the JAX package) as kernels
for the H100: K10 `repro_f32_iota`, K11 `repro_slice_broadcast_layout`,
K12 `repro_scalar_reduce`, K13 `repro_dynamic_cull` (probes A-D), K14
`repro_dot_k3_subslice`, all in csrc/mosaic_repros.cu, and `tile_32768`,
the tiled integrator at the tile width the TPU faults on.

Each repro module holds, for each of its formulations, a `*_kernel` (the
CUDA kernel, counted in the module's KERNEL_LAUNCHES), a `*_reference`
(the plain PyTorch version) and `run(device)`, one row a formulation: µs a
launch (the CUDA-event mean of 200 launches in a row), the plain
version's µs, the bound, the library call's µs where one PyTorch call
computes the same function, the max abs error against the plain version,
whether the pair's forms are equal and whether the repro's own answer
came out, and the card (`tools.card_line`). CLI:

    python -m raytracingweekend_tpu_torch.tools.mosaic_repros
        [--only k10,k11,k12,k13,k14,tile] [--device cuda|cpu]
        [--launches 200] [--json rows.jsonl]
"""
from __future__ import annotations

from .. import card_line
from . import (repro_dot_k3_subslice, repro_dynamic_cull, repro_f32_iota,
               repro_scalar_reduce, repro_slice_broadcast_layout)

REPROS = {"k10": repro_f32_iota, "k11": repro_slice_broadcast_layout,
          "k12": repro_scalar_reduce, "k13": repro_dynamic_cull,
          "k14": repro_dot_k3_subslice}


def kernel_launches() -> dict:
    """Every repro kernel's launch count, by name."""
    return {k: v for m in REPROS.values() for k, v in
            m.KERNEL_LAUNCHES.items()}


def reset_launches() -> None:
    for m in REPROS.values():
        for name in m.KERNEL_LAUNCHES:
            m.KERNEL_LAUNCHES[name] = 0


def run(device="cuda", only=tuple(REPROS), launches: int = 200,
        outputs=None) -> list:
    """The rows of the named repros (k10..k14), in that order; `outputs`,
    a dict, gets each formulation's (output, plain output). Raises on a
    CUDA device when there is no card."""
    card_line(device)
    rows = []
    for key in only:
        rows += REPROS[key].run(device, launches, outputs)
    return rows
