"""Bounding-volume hierarchy over the sphere table.

The port of raytracingweekend_tpu/ops/bvh.py. The reference's bvh_node
(hittable.h:41-140) is never instantiated and is broken; this is the JAX
package's working replacement:

- built on the host with numpy: top-down median split on the widest
  centroid axis over motion-expanded sphere AABBs (sphere.h:27-37), node
  arrays bitwise the JAX package's;
- flattened to a DFS pre-order array with skip links, so traversal needs
  no stack: on a box hit advance to node + 1, on a miss (or after a leaf)
  jump to skip[node];
- traversed in plain PyTorch, every ray stepping through its own cursor
  (the JAX traversal is plain XLA, no kernel).
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .intersect import BIG
from . import linalg
from .syncs import CHECK_EVERY, any_set

LEAF_SIZE = 4  # max spheres per leaf; static unroll bound in traversal


@dataclasses.dataclass
class SphereBVH:
    """Flattened skip-link BVH, M nodes in DFS pre-order (numpy)."""
    bbox_min: np.ndarray  # (M, 3) float32
    bbox_max: np.ndarray  # (M, 3) float32
    skip: np.ndarray      # (M,) int32: next node on a miss / after a leaf
    first: np.ndarray     # (M,) int32: first slot in `order` (leaves)
    count: np.ndarray     # (M,) int32: spheres in the leaf; 0 if internal
    order: np.ndarray     # (S_active,) int32: leaf-order sphere rows


def _sphere_bounds(spheres):
    """Motion-expanded per-sphere AABBs in float64."""
    c0 = np.asarray(spheres.center0, np.float64)
    c1 = np.asarray(spheres.center1, np.float64)
    r = np.abs(np.asarray(spheres.radius, np.float64))[:, None]
    return np.minimum(c0, c1) - r, np.maximum(c0, c1) + r


def build_sphere_bvh(spheres, leaf_size: int = LEAF_SIZE) -> SphereBVH:
    """Top-down median-split build over the ACTIVE spheres."""
    idx_all = np.nonzero(np.asarray(spheres.active))[0].astype(np.int32)
    lo, hi = _sphere_bounds(spheres)
    centroids = (lo + hi) * 0.5
    nodes_min, nodes_max, sizes, first, count = [], [], [], [], []
    order: list[int] = []

    def emit(idx) -> int:
        """Append the subtree over sphere rows `idx` in DFS pre-order;
        returns its node count."""
        me = len(sizes)
        nodes_min.append(lo[idx].min(axis=0))
        nodes_max.append(hi[idx].max(axis=0))
        sizes.append(1)
        if len(idx) <= leaf_size:
            first.append(len(order))
            count.append(len(idx))
            order.extend(int(i) for i in idx)
            return 1
        first.append(-1)
        count.append(0)
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = len(idx) // 2
        part = idx[np.argsort(c[:, axis], kind="stable")]
        n = 1 + emit(part[:mid])
        n += emit(part[mid:])
        sizes[me] = n
        return n

    if len(idx_all) == 0:
        z3 = np.zeros((1, 3), np.float32)
        return SphereBVH(bbox_min=z3, bbox_max=z3.copy(),
                         skip=np.asarray([1], np.int32),
                         first=np.asarray([0], np.int32),
                         count=np.asarray([0], np.int32),
                         order=np.zeros((0,), np.int32))
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * len(idx_all) + 100))
    try:
        emit(idx_all)
    finally:
        sys.setrecursionlimit(old_limit)
    M = len(sizes)
    # in pre-order, resuming after node n's subtree is n + its size; M ends
    skip = (np.arange(M, dtype=np.int64)
            + np.asarray(sizes, np.int64)).astype(np.int32)
    return SphereBVH(
        bbox_min=np.asarray(nodes_min).astype(np.float32),
        bbox_max=np.asarray(nodes_max).astype(np.float32),
        skip=skip, first=np.asarray(first, np.int32),
        count=np.asarray(count, np.int32),
        order=np.asarray(order, np.int32))


def _leaf_sphere_t(o, d, time, t_min, spheres, si, moving: bool):
    """Candidate t of one gathered sphere row per ray (N,); BIG on a miss."""
    c = spheres.center0[si]
    if moving:
        dt = spheres.time1[si] - spheres.time0[si]
        nz = dt != 0
        inv_dt = torch.where(nz, 1.0 / torch.where(nz, dt, torch.ones_like(dt)),
                             torch.zeros_like(dt))
        frac = (time - spheres.time0[si]) * inv_dt
        c = c + frac[:, None] * (spheres.center1[si] - spheres.center0[si])
    oc = o - c
    a = linalg.dot(d, d)
    b = linalg.dot(oc, d)
    r = spheres.radius[si]
    cc = linalg.dot(oc, oc) - r * r
    disc = b * b - a * cc
    sq = linalg.safe_sqrt(disc)
    t_near = (-b - sq) / a
    t_far = (-b + sq) / a
    t_cand = torch.where(t_near > t_min, t_near, t_far)
    valid = (disc > 0) & (t_cand > t_min)
    return torch.where(valid, t_cand, torch.full_like(t_cand, BIG))


def hit_spheres_bvh(o, d, time, t_min, spheres, bvh, moving: bool):
    """Closest sphere hit by stackless skip-link traversal, every ray in
    lockstep through its own cursor: (best_t (N,), best_idx (N,) int64),
    as geometry.hit_spheres returns. `spheres` and `bvh` hold the scene's
    tensors on the rays' device (packing.DeviceScene); the loop condition
    is read on the host every CHECK_EVERY steps (ops/syncs.py)."""
    N = o.shape[0]
    M = bvh.skip.shape[0]
    S_ord = bvh.order.shape[0]
    inv_d = 1.0 / d
    node = torch.zeros((N,), dtype=torch.int64, device=o.device)
    best_t = torch.full((N,), BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((N,), -1, dtype=torch.int64, device=o.device)
    step = 0
    while True:
        if step % CHECK_EVERY == 0 and not any_set(node < M, "bvh"):
            break
        step += 1
        safe = torch.clamp_max(node, M - 1)
        t0 = (bvh.bbox_min[safe] - o) * inv_d
        t1 = (bvh.bbox_max[safe] - o) * inv_d
        tlo = torch.minimum(t0, t1).amax(dim=-1)
        thi = torch.maximum(t0, t1).amin(dim=-1)
        box_hit = torch.clamp_min(tlo, t_min) < torch.minimum(thi, best_t)
        cnt = bvh.count[safe]
        is_leaf = cnt > 0
        test_leaf = box_hit & is_leaf
        for k in range(LEAF_SIZE):
            in_leaf = test_leaf & (k < cnt)
            slot = torch.clamp(bvh.first[safe] + k, 0, max(S_ord - 1, 0))
            si = bvh.order[slot] if S_ord else torch.zeros_like(slot)
            t_cand = _leaf_sphere_t(o, d, time, t_min, spheres, si, moving)
            better = in_leaf & (t_cand < best_t)
            best_t = torch.where(better, t_cand, best_t)
            best_i = torch.where(better, si, best_i)
        live = node < M
        nxt = torch.where(box_hit & ~is_leaf, node + 1, bvh.skip[safe])
        node = torch.where(live, nxt, node)
    return best_t, best_i
