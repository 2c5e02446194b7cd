"""The reference's render loop: the image a `render()` call must produce,
recomputed on a sample of the launch's tiles.

A render accumulates launches of `samples_per_launch` samples (the last
one the rest) into a float32 canvas and divides by the samples; launch k
draws the kernel seed `randint(fold_in(key(seed), k), (1, 1), 0,
2**31 - 1)`. Tiles are independent and keep their random streams, so the
reference traces only the tiles it is asked for and returns the pixels
they cover.
"""
from __future__ import annotations

import numpy as np
import torch

from . import megakernel as mk
from . import prng


def launch_seed(seed: int, launch: int) -> int:
    """The int32 kernel seed of launch `launch` of a render seeded
    `seed`."""
    k = prng.fold_in(prng.key(seed), launch)
    return int(prng.randint(k, (1, 1), 0, 2 ** 31 - 1, device="cpu")[0, 0])


def launches(spp: int, samples_per_launch: int) -> list:
    """The samples of each launch of a render of `spp` samples."""
    chunk = min(samples_per_launch, spp)
    out, done = [], 0
    while done < spp:
        out.append(min(chunk, spp - done))
        done += out[-1]
    return out


def tile_pixels(scene, nx: int, ny: int, spp: int, tiles: torch.Tensor,
                plan_kw: dict) -> torch.Tensor:
    """Flat pixel indices (row-major, row 0 = image bottom) of the valid
    lanes of `tiles` in the layout of the plan that `plan_kw` sets."""
    _, plan = mk.make_plan(scene, nx, ny, spp, **plan_kw)
    args, inv = mk.device_inputs(scene, plan, "cpu")
    pixf = args[0]
    sel = pixf[tiles.cpu()]
    valid = sel[:, 2, :] > 0
    pix = (sel[:, 1, :] * nx + sel[:, 0, :])[valid].long()
    return torch.unique(pix)


def render_tiles(scene, nx: int, ny: int, spp: int, max_depth: int,
                 samples_per_launch: int, jobs: list, plan_kw: dict, device,
                 canvas_dtype=torch.float32) -> list:
    """The (ny, nx, 3) float32 images of renders of `scene`, one a job
    (seed, tiles): the render seeded `seed`, traced on `tiles` (indices
    into a launch's tile list) only; pixels of other tiles read 0.
    `plan_kw` are the launch-plan keywords of `make_plan` (tile width and
    layout modes); `canvas_dtype` is the precision each launch's sums
    are accumulated in.

    The tiles of every launch of one size, across jobs, run as one call
    of the plain version, each keyed by its launch's seed (`tile_key`);
    the launches then accumulate in their order, as a render does."""
    sizes = launches(spp, samples_per_launch)
    images = {}
    for size in sorted(set(sizes)):
        _, plan = mk.make_plan(scene, nx, ny, size, max_depth=max_depth,
                               **plan_kw)
        args, inv = mk.device_inputs(scene, plan, device)
        pixf = args[0]
        todo = [(j, n) for j in range(len(jobs))
                for n, s in enumerate(sizes) if s == size]
        sel = [jobs[j][1].to(pixf.device) for j, _ in todo]
        keys = torch.cat([
            mk.tile_key(launch_seed(jobs[j][0], n), t)
            for (j, n), t in zip(todo, sel)])
        out = mk.trace_mega_reference(
            torch.cat([pixf[t] for t in sel]), *args[1:], 0, plan,
            tile_keys=keys)
        at = 0
        for (j, n), t in zip(todo, sel):
            full = out.new_zeros((pixf.shape[0],) + out.shape[1:])
            full[t] = out[at:at + len(t)]
            at += len(t)
            images[j, n] = mk._epilogue(full, inv, plan).image
    result = []
    for j in range(len(jobs)):
        acc = torch.zeros((ny, nx, 3), dtype=canvas_dtype, device=device)
        for n in range(len(sizes)):
            acc += images[j, n].to(canvas_dtype)
        result.append((acc / max(spp, 1)).to(torch.float32))
    return result


def sample_tiles(n_tiles: int, n: int, rng: np.random.Generator
                 ) -> torch.Tensor:
    """`n` distinct tile indices of `n_tiles`, drawn from `rng`, sorted."""
    n = min(n, n_tiles)
    return torch.from_numpy(np.sort(rng.choice(n_tiles, n, replace=False)))
