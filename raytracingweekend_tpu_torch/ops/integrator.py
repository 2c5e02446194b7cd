"""Pixel ordering shared by the per-pixel-slot integrators.

The port's counterpart of raytracingweekend_tpu/ops/integrator.py carries
only the block-linear pixel permutation the megakernel's layout uses; the
wavefront integrators come with ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import numpy as np


def _block_linear_order(nx: int, ny: int, block: int = 32):
    """Pixel permutation: raster order over (block x block) tiles, raster
    within each tile, so consecutive indices cover compact 2D regions and a
    tile of slots sees coherent content. Returns (order (n_pix,), inverse
    (n_pix,)) as numpy int32."""
    ys, xs = np.mgrid[0:ny, 0:nx]
    keys = (((ys // block) * ((nx + block - 1) // block) + (xs // block))
            * (block * block)
            + (ys % block) * block + (xs % block))
    order = np.argsort(keys.reshape(-1), kind="stable").astype(np.int32)
    inverse = np.empty_like(order)
    inverse[order] = np.arange(order.size, dtype=np.int32)
    return order, inverse
