"""Wavefront path-tracing integrators.

The port of raytracingweekend_tpu/ops/integrator.py (reference:
RayTracingWeekend.cpp:45-160): the recursive color() becomes a bounce loop
over a wavefront of N rays carrying (origin, direction, throughput,
radiance, active),

    radiance += throughput * emitted(vertex)
    throughput *= attenuation * scattering_pdf / pdf_val   (pdf materials)
    throughput *= attenuation                              (specular)

Integrators:
- `trace` in "while" mode stops once every ray has terminated, in "scan"
  mode runs max_depth bounces with no host read, an autograd graph over
  the scene's tensor leaves (grad.render_diff);
- `trace_regenerative`, the production forward path: persistent slots that
  pull the next (pixel, sample) when their path ends;
- `trace_tiled`: per-pixel slots, scatter-free accumulation.

Every closest hit goes through ops/geometry.py (kernel K7 on the card);
the rest is plain PyTorch on the rays' device. Random numbers come from
the JAX package's keys (utils/prng.py), so on the same key the port draws
JAX's uniforms lane for lane.

The loop conditions that JAX evaluates on the device (`jnp.any`) are host
reads here, made every CHECK_EVERY iterations and counted in SYNCS
(ops/syncs.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import scene_types as st
from ..utils import prng
from . import camera as camera_mod
from . import linalg, materials, sampling
from .geometry import closest_hit
from .packing import DeviceScene, device_scene
from .syncs import CHECK_EVERY, any_set

_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.5, 0.7, 1.0)


def _background(d, ds: DeviceScene):
    """Miss shading (RayTracingWeekend.cpp:143-158)."""
    if ds.scene.background == st.BG_BLACK:
        return torch.zeros_like(d)
    unit = linalg.normalize(d)
    t = 0.5 * (unit[..., 1] + 1.0)
    white = torch.tensor(_WHITE, dtype=d.dtype, device=d.device)
    blue = torch.tensor(_BLUE, dtype=d.dtype, device=d.device)
    # the reference's swapped-argument lerp (vec3.h:84-87)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def _bounce(ds: DeviceScene, base_key, bounce: int, o, d, time, tp, radiance,
            active, depth=None, rr_depth=None):
    """One wavefront bounce, one level of the color() recursion. With
    `rr_depth`, Russian roulette ends low-throughput paths past that depth
    with survival probability max(tp) (clamped to [0.05, 0.95]), dividing
    the survivors' throughput by it."""
    kb = prng.fold_in(base_key, bounce)
    k_med, k_shade = prng.split(kb)

    hit = closest_hit(k_med, o, d, time, ds)
    live = active & hit.hit
    miss = active & ~hit.hit

    zeros3 = torch.zeros_like(tp)
    radiance = radiance + torch.where(miss[:, None], tp * _background(d, ds),
                                      zeros3)
    if ds.scene.render_type == st.RENDER_NORMAL:
        # RenderType::Normal (cpp:135-136): 0.5 (normal + 1), one bounce
        radiance = radiance + torch.where(live[:, None],
                                          0.5 * (hit.normal + 1.0), zeros3)
        return o, d, tp, radiance, torch.zeros_like(active)

    sr = materials.shade(k_shade, d, hit, ds)
    radiance = radiance + torch.where(live[:, None], tp * sr.emitted, zeros3)
    tp = torch.where(live[:, None], tp * sr.weight, tp)
    alive = live & sr.scatter & (tp > 0.0).any(dim=-1)
    if rr_depth is not None and depth is not None:
        p_cont = torch.clamp(tp.amax(dim=-1), 0.05, 0.95)
        do_rr = alive & (depth >= rr_depth)
        u = sampling.uniform(prng.fold_in(kb, 7), do_rr.shape,
                             device=o.device)
        survive = ~do_rr | (u < p_cont)
        tp = torch.where((do_rr & survive)[:, None], tp / p_cont[:, None], tp)
        alive = alive & survive
    o = torch.where(alive[:, None], hit.p, o)
    d = torch.where(alive[:, None], sr.direction, d)
    return o, d, tp, radiance, alive


def trace(key, o, d, time, scene: st.Scene, max_depth: int = 100,
          mode: str = "while"):
    """Radiance (N, 3) of N rays on their device. At most `max_depth`
    scatter events (cpp:42,47-48). "while" stops when every ray has ended
    (read every CHECK_EVERY bounces), "scan" runs all max_depth."""
    if mode not in ("while", "scan"):
        raise ValueError(f"unknown trace mode {mode!r}")
    ds = device_scene(scene, o.device)
    N = o.shape[0]
    tp = torch.ones((N, 3), dtype=o.dtype, device=o.device)
    radiance = torch.zeros((N, 3), dtype=o.dtype, device=o.device)
    active = torch.ones((N,), dtype=torch.bool, device=o.device)
    for bounce in range(max_depth):
        if (mode == "while" and bounce % CHECK_EVERY == 0
                and not any_set(active, "while")):
            break
        o, d, tp, radiance, active = _bounce(ds, key, bounce, o, d, time, tp,
                                             radiance, active)
    return radiance


def trace_with_stats(key, o, d, time, scene: st.Scene, max_depth: int = 100):
    """trace(mode="while") and the number of path segments cast (the sum
    over bounces of active rays), as an int64 tensor."""
    ds = device_scene(scene, o.device)
    N = o.shape[0]
    tp = torch.ones((N, 3), dtype=o.dtype, device=o.device)
    radiance = torch.zeros((N, 3), dtype=o.dtype, device=o.device)
    active = torch.ones((N,), dtype=torch.bool, device=o.device)
    count = torch.zeros((), dtype=torch.int64, device=o.device)
    for bounce in range(max_depth):
        if bounce % CHECK_EVERY == 0 and not any_set(active, "while"):
            break
        count = count + active.sum()
        o, d, tp, radiance, active = _bounce(ds, key, bounce, o, d, time, tp,
                                             radiance, active)
    return radiance, count


def _pixel_rays(ds: DeviceScene, k, pix, nx: int, ny: int):
    """Jittered camera rays through pixels `pix` (cpp:227-228)."""
    i = (pix % nx).float()
    j = torch.div(pix, nx, rounding_mode="floor").float()
    k_u, k_v, k_cam = prng.split(k, 3)
    u = (i + sampling.uniform(k_u, pix.shape, device=pix.device)) / nx
    v = (j + sampling.uniform(k_v, pix.shape, device=pix.device)) / ny
    return camera_mod.get_rays(k_cam, ds.camera, u, v)


def trace_regenerative(key, scene: st.Scene, nx: int, ny: int, spp: int,
                       max_depth: int = 100, n_slots: int = 1 << 19,
                       rr_depth: int | None = 4, device="cuda"):
    """Path-regenerative wavefront integrator (Laine et al. 2013): each of
    `n_slots` persistent slots pulls the next global ray id when its path
    ends, so utilization stays near 100% until the frame's tail. Ray k of
    nx*ny*spp covers pixel k % n_pix. RNG is keyed per (slot, iteration),
    as in the JAX package. Finished paths deposit with index_add_ (float
    atomics on the card: the last bits of a pixel's sum vary run to run).

    Returns (radiance sum image (ny, nx, 3), segment count (), iterations)
    on `device`."""
    ds = device_scene(scene, device)
    dev = ds.device
    n_pix = nx * ny
    total = n_pix * spp
    n_slots = min(n_slots, total)

    def fresh_rays(k, ray_id, live):
        pix = ray_id % n_pix
        o, d, t = _pixel_rays(ds, k, pix, nx, ny)
        return torch.where(live, pix, torch.full_like(pix, n_pix)), o, d, t

    k_init, k_loop = prng.split(key)
    ray0 = torch.arange(n_slots, dtype=torch.int64, device=dev)
    pix, o, d, time = fresh_rays(k_init, ray0, ray0 < total)
    image = torch.zeros((n_pix + 1, 3), dtype=torch.float32, device=dev)
    tp = torch.ones((n_slots, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros((n_slots,), dtype=torch.int64, device=dev)
    rad = torch.zeros((n_slots, 3), dtype=torch.float32, device=dev)
    next_ray = torch.full((), n_slots, dtype=torch.int64, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it % CHECK_EVERY or any_set(pix < n_pix, "regen"):
        active = pix < n_pix
        segments = segments + active.sum()
        kb = prng.fold_in(k_loop, it)
        o2, d2, tp2, rad2, alive = _bounce(ds, kb, 0, o, d, time, tp, rad,
                                           active, depth=depth,
                                           rr_depth=rr_depth)
        depth = depth + 1
        alive = alive & (depth < max_depth)
        finished = active & ~alive
        # deposit finished paths (others land on the dummy row n_pix)
        dep_pix = torch.where(finished, pix, torch.full_like(pix, n_pix))
        image.index_add_(0, dep_pix, torch.where(finished[:, None], rad2,
                                                 torch.zeros_like(rad2)))
        # regenerate: finished slots take the next global ray ids
        fin = finished.long()
        new_id = next_ray + torch.cumsum(fin, 0) - 1
        take = finished & (new_id < total)
        next_ray = next_ray + fin.sum()
        kg = prng.fold_in(kb, 1)
        pix_n, o_n, d_n, t_n = fresh_rays(
            kg, torch.where(take, new_id, torch.zeros_like(new_id)), take)
        pix = torch.where(alive, pix, torch.where(take, pix_n,
                                                  torch.full_like(pix, n_pix)))
        o = torch.where(alive[:, None], o2, o_n)
        d = torch.where(alive[:, None], d2, d_n)
        time = torch.where(alive, time, t_n)
        tp = torch.where(alive[:, None], tp2, torch.ones_like(tp2))
        rad = torch.where(alive[:, None], rad2, torch.zeros_like(rad2))
        depth = torch.where(alive, depth, torch.zeros_like(depth))
        it += 1
    return image[:n_pix].reshape(ny, nx, 3), segments, it


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


def _tile_width(n_slots: int, k: int) -> int:
    """Pixels per tile of the tiled integrator. The JAX package moves the
    width 1 << 15 to 1 << 16 to sidestep a TPU miscompile; the port has no
    such guard."""
    return max(n_slots // k, 256)


def trace_tiled(key, scene: st.Scene, nx: int, ny: int, spp: int,
                max_depth: int = 100, n_slots: int = 1 << 19,
                spp_per_slot: int | None = None, rr_depth: int | None = 4,
                device="cuda"):
    """Tiled per-pixel-slot wavefront integrator: each slot is bound to one
    pixel for a whole launch. A tile of T pixels runs k sample-parallel
    slots per pixel, each retracing its pixel for `spp_per_slot` samples;
    accumulation is dense (no scatter). Tiles run one after another in the
    block-linear pixel order.

    Returns (radiance sum image (ny, nx, 3), segment count (), iterations)
    on `device`."""
    ds = device_scene(scene, device)
    dev = ds.device
    n_pix = nx * ny
    if spp_per_slot is None:
        spp_per_slot = max(min(spp, 8), spp // max(n_slots // n_pix, 1))
    while spp % spp_per_slot:
        spp_per_slot -= 1
    k = spp // spp_per_slot
    T = _tile_width(n_slots, k)
    slots = T * k
    n_tiles = -(-n_pix // T)
    n_pad = n_tiles * T
    order_np, inv = _block_linear_order(nx, ny)
    order = torch.from_numpy(np.pad(order_np, (0, n_pad - n_pix),
                                    constant_values=n_pix).astype(
        np.int64)).to(dev)
    image = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    lane = torch.arange(T, dtype=torch.int64, device=dev).repeat(k)
    iters = 0
    for tile in range(n_tiles):
        base = tile * T
        pix = order[base + lane]
        valid_pix = pix < n_pix
        pix = torch.clamp_max(pix, n_pix - 1)
        kt = prng.fold_in(key, tile)
        o, d, time = _pixel_rays(ds, prng.fold_in(kt, 0), pix, nx, ny)
        tp = torch.ones((slots, 3), dtype=torch.float32, device=dev)
        rad = torch.zeros((slots, 3), dtype=torch.float32, device=dev)
        accum = torch.zeros((slots, 3), dtype=torch.float32, device=dev)
        depth = torch.zeros((slots,), dtype=torch.int64, device=dev)
        done = torch.where(valid_pix, 0, spp_per_slot)
        it = 0
        while it % CHECK_EVERY or any_set(done < spp_per_slot, "tiled"):
            active = done < spp_per_slot
            segments = segments + active.sum()
            kb = prng.fold_in(kt, it + 1)
            o2, d2, tp2, rad2, alive = _bounce(ds, kb, 0, o, d, time, tp,
                                               rad, active, depth=depth,
                                               rr_depth=rr_depth)
            depth = depth + 1
            alive = alive & (depth < max_depth)
            finished = active & ~alive
            accum = accum + torch.where(finished[:, None], rad2,
                                        torch.zeros_like(rad2))
            done = done + finished.long()
            o_n, d_n, t_n = _pixel_rays(ds, prng.fold_in(kb, 1), pix, nx, ny)
            o = torch.where(alive[:, None], o2, o_n)
            d = torch.where(alive[:, None], d2, d_n)
            time = torch.where(alive, time, t_n)
            tp = torch.where(alive[:, None], tp2, torch.ones_like(tp2))
            rad = torch.where(alive[:, None], rad2, torch.zeros_like(rad2))
            depth = torch.where(alive, depth, torch.zeros_like(depth))
            it += 1
        iters += it
        image[base:base + T] += accum.reshape(k, T, 3).sum(dim=0)
    inv_t = torch.from_numpy(inv.astype(np.int64)).to(dev)
    return image[inv_t].reshape(ny, nx, 3), segments, iters
