"""Closest-hit rays a second: kernel K7 against the skip-link BVH.

The port of tools/bvh_bench.py. For each sphere count S, N random rays
against S random static spheres through three paths:

- k7: `intersect.hit_spheres_kernel`, the kernel (its plain version on
  the CPU);
- bvh-skiplink: `bvh.hit_spheres_bvh`, the stackless traversal in plain
  torch (the JAX package's is plain XLA);
- plain-brute: `intersect.hit_spheres_reference`, K7's plain version, a
  correctness reference and not a yardstick. It runs only where
  N x S <= 2^32 (`BRUTE_MAX_PAIRS`).

Each path is timed on the host clock between device synchronisations,
the mean of `--repeats` calls after one warm-up. Each size's k7 and
bvh-skiplink rows report how far they agree with plain-brute or, where
it does not run, with each other: the share of rays with the same best
index (a miss counts as index -1) and max |dt| and max |dt| / t where
the index is the same; the tool exits 1 where fewer than `AGREE_MIN`
of the rays have the same index and, on a hit, t within `T_RTOL`.
Origins, centres and radii are the JAX tool's uniform draws from its
keys (`uniform`: utils/prng's bits, scaled as XLA:CPU scales them); the
directions are numpy's seeded normals,
normalised, not the JAX tool's `jax.random.normal` rays. The JAX tool's
VMEM cap on S (the Pallas table had to fit VMEM) does not apply: K7
streams any S through shared memory.

    python -m raytracingweekend_tpu_torch.tools.bvh_bench
        [--rays 1048576] [--sizes 512,4096,32768] [--repeats 3]
        [--out rows.jsonl] [--device cuda|cpu]

It prints a line a row, then one JSON row each (the JAX tool's keys, the
card's name and power limit under "device"), and appends them to `--out`
when given.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import card_line
from .grad_bench import synced_s
from ..models import scene_types as st
from ..ops import intersect
from ..ops.bvh import build_sphere_bvh, hit_spheres_bvh
from ..ops.packing import _to_device
from ..ops.rounding import _fma_rn
from ..utils import prng

BRUTE_MAX_PAIRS = 1 << 32
T_MIN = 0.001
# agreement of k7 and bvh-skiplink with plain-brute (or each other): a
# ray agrees where its best index is the same and, on a hit, |dt| <=
# T_RTOL t; at least AGREE_MIN of the rays must. The BVH's quadratic
# rounds otherwise than K7's (no written-out FMAs, its own a = d.d), so t
# moves by ulps, more near tangency and where an origin inside a sphere
# takes the far root by cancellation; a grazing ray may flip its index
T_RTOL = 1e-4
AGREE_MIN = 0.999


def uniform(k, shape, lo: float, hi: float, device) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, lo, hi)` as XLA:CPU computes
    it: the scale and shift of prng.uniform's [0, 1) draw contracted into
    one FMA (ROADMAP N1), then clamped at lo."""
    u = prng.uniform(k, shape, device=device)
    span = float(np.float32(hi) - np.float32(lo))
    return torch.clamp_min(_fma_rn(u, span, lo), float(np.float32(lo)))


def rays(n: int, device) -> tuple:
    """o (uniform in [-20, 20)^3 from the JAX tool's key), unit d (numpy's
    seeded normals) and time 0, float32 on `device`."""
    ko, _, _ = prng.split(prng.key(0), 3)
    o = uniform(ko, (n, 3), -20.0, 20.0, device)
    d = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o, torch.from_numpy(d).to(device),
            torch.zeros((n,), dtype=torch.float32, device=device))


def spheres_of(S: int) -> st.Spheres:
    """S static spheres: centres in [-20, 20)^3 and radii in [0.2, 1.0),
    drawn from the JAX tool's keys for S."""
    _, _, ks = prng.split(prng.key(0), 3)
    kc, kr = prng.split(prng.fold_in(ks, S))
    c = uniform(kc, (S, 3), -20.0, 20.0, "cpu").numpy()
    r = uniform(kr, (S,), 0.2, 1.0, "cpu").numpy()
    return st.Spheres(center0=c, center1=c.copy(),
                      time0=np.zeros((S,), np.float32),
                      time1=np.ones((S,), np.float32), radius=r,
                      mat=np.zeros((S,), np.int32),
                      active=np.ones((S,), bool))


def paths(spheres: st.Spheres, n: int, device) -> dict:
    """The three paths as closures over one size's inputs (plain-brute
    only where n x S <= BRUTE_MAX_PAIRS)."""
    o, d, tm = rays(n, device)
    table = torch.from_numpy(intersect.pack_spheres(spheres)).to(device)
    layout = intersect.sphere_layout(table, False)
    k7 = (intersect.hit_spheres_kernel if torch.device(device).type == "cuda"
          else intersect.hit_spheres_reference)
    sph = _to_device(spheres, device)
    tree = _to_device(build_sphere_bvh(spheres), device)
    out = {"k7": lambda: k7(o, d, tm, table, False, T_MIN, layout=layout),
           "bvh-skiplink": lambda: hit_spheres_bvh(o, d, tm, T_MIN, sph,
                                                   tree, False)}
    if n * spheres.radius.shape[0] <= BRUTE_MAX_PAIRS:
        out["plain-brute"] = lambda: intersect.hit_spheres_reference(
            o, d, tm, table, False, T_MIN, layout=layout)
    return out


def agreement(a: tuple, b: tuple) -> dict:
    """How far (best_t, best_i) a agrees with b: the share of rays with
    the same index (a miss as -1), the share that also meet T_RTOL on a
    hit, and max |dt| and max |dt| / t over the hits of the same index."""
    (ta, ia), (tb, ib) = ((t.double(), torch.where(t < intersect.BIG, i, -1))
                          for t, i in (a, b))
    same = ia == ib
    hit = same & (ib >= 0)
    dt = torch.where(hit, (ta - tb).abs(), 0.0)
    rel = dt / torch.where(hit, tb.abs(), 1.0)
    return dict(same_index=float(same.double().mean()),
                agree=float((same & (rel <= T_RTOL)).double().mean()),
                max_abs_dt=float(dt.max()), max_rel_dt=float(rel.max()))


def run(n: int, sizes, repeats: int, device) -> list:
    """One row a path a size (see the module docstring)."""
    card = card_line(device)
    rows = []
    for S in sizes:
        results, size_rows = {}, {}
        for label, fn in paths(spheres_of(S), n, device).items():
            synced_s(fn, device)                       # warm-up
            dt = 0.0
            for _ in range(repeats):
                secs, results[label] = synced_s(fn, device)
                dt += secs / repeats
            size_rows[label] = dict(S=S, path=label, rays=n, seconds=dt,
                                    rays_per_s=n / dt,
                                    plain=label == "plain-brute"
                                    or torch.device(device).type != "cuda")
            print(f"S={S:6d} {label:14s} {dt * 1e3:11.3f} ms "
                  f"{n / dt / 1e6:10.3f} M rays/s"
                  f"{' (plain version)' if size_rows[label]['plain'] else ''}",
                  flush=True)
        for label, other in (("k7", "bvh-skiplink"), ("bvh-skiplink", "k7")):
            ref = "plain-brute" if "plain-brute" in results else other
            agree = agreement(results[label], results[ref])
            agree["passed"] = agree["agree"] >= AGREE_MIN
            size_rows[label].update(agree_with=ref, **agree)
            print(f"S={S:6d} {label:14s} vs {ref}: same index "
                  f"{agree['same_index']:.6f}, within rtol {T_RTOL} "
                  f"{agree['agree']:.6f} (>= {AGREE_MIN}), max |dt| "
                  f"{agree['max_abs_dt']:.3e}, max |dt|/t "
                  f"{agree['max_rel_dt']:.3e}: "
                  f"{'ok' if agree['passed'] else 'FAIL'}", flush=True)
        for row in size_rows.values():
            row["device"] = card
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--sizes", default="512,4096,32768")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None, help="append the rows here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.rays, [int(s) for s in args.sizes.split(",")],
               args.repeats, args.device)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r.get("passed", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
