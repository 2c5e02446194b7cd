"""The comparison that decides `correct`: the images the timed path
produced against the reference's, pixel by pixel, on the tiles the
reference traced.

The reference recomputes the very samples of each launch (the same
counter-hash random numbers, keyed by seed, tile, iteration and lane), so
a sound program agrees with it value for value. A pixel channel counts as
a mismatch where the two differ by more than RTOL of the reference's
value and ATOL; `mismatch_share` is the share of compared channels that
do, and a non-finite value is a mismatch. Its limit is the
configuration's (`check.limits`).
"""
from __future__ import annotations

import torch

RTOL = 1e-5
ATOL = 1e-7


def mismatches(prog: torch.Tensor, ref: torch.Tensor,
               pix: torch.Tensor) -> tuple:
    """(mismatched channels, compared channels) of the flat pixels `pix`
    of two (ny, nx, 3) images."""
    idx = pix.to(prog.device)
    a = prog.reshape(-1, 3)[idx].float()
    b = ref.to(prog.device).reshape(-1, 3)[idx].float()
    bad = ~torch.isclose(a, b, rtol=RTOL, atol=ATOL) | ~torch.isfinite(a)
    return int(bad.sum()), bad.numel()


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, lines): each number compared beside its limit, correct
    where every number is at or under its limit and none is missing."""
    ok = bool(readings) and all(
        name in readings and readings[name] <= limit
        for name, limit in limits.items())
    lines = [f"{name} {readings.get(name)} limit {limit}"
             for name, limit in limits.items()]
    return ok, lines
