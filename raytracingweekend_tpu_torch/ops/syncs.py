"""Host reads of the wavefront's loop conditions.

The JAX package evaluates its loop conditions (`jnp.any`) on the device;
the port reads them on the host, each read a device -> host sync. An
iteration after a condition turned false changes nothing (every lane is
idle), so the loops read it only every CHECK_EVERY iterations. SYNCS
counts the reads of each loop: the integrators' "while", "regen" and
"tiled" and the BVH traversal's "bvh".
"""
from __future__ import annotations

import torch

CHECK_EVERY = 4

SYNCS = {"while": 0, "regen": 0, "tiled": 0, "bvh": 0}


def any_set(flag: torch.Tensor, loop: str) -> bool:
    """Whether any element of `flag` is set, read on the host and counted
    in SYNCS[loop]."""
    SYNCS[loop] += 1
    return bool(flag.any())
