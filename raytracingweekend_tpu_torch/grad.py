"""Differentiable rendering and inverse rendering.

The port of raytracingweekend_tpu/grad.py. The reference has no gradient;
this is what the JAX package adds to it (pixel gradients that match finite
differences, and inverse rendering by gradient descent on scene
parameters):

- the forward path is the fixed-depth "scan" wavefront integrator, an
  ordinary torch autograd graph whose closest sphere hit is
  `geometry.HitSpheres` (kernel K7 forward, winner-quadratic backward);
- sampling is reparameterised: the uniforms are parameter-free, so sampled
  directions are differentiable through the ONB frame, the normals and
  Snell's law, and only the discrete decisions (hit or miss, material
  branch, mixture coin, reflect or refract coin) carry no gradient, which
  is what fixed-key finite differences measure;
- with a fixed key the renderer is a deterministic function of the scene.

A differentiable scene is an ordinary scene in which `dataclasses.replace`
has put float32 tensors with requires_grad into continuous leaves
(`textures.color`, `spheres.center0` / `radius`, `materials.fuzz` /
`ref_idx`, `media.density`, `camera.origin`, ...); the structure stays
numpy. The megakernel-backed counterparts (ops/mega_grad.py: a winner tape
from the CUDA megakernel and its autograd replay) are re-exported here:
`render_diff_mega`, `fit_scene_params_mega`.

Entry points take `device` ("cuda" by default).
"""
from __future__ import annotations

import dataclasses
import inspect
import json
from typing import Callable

import torch

from .models import scene_types as st
from .ops.integrator import trace
from .ops.mega_grad import (  # noqa: F401  (re-exported public surface)
    fit_scene_params_mega, render_diff_mega)
from .ops.packing import leaf_tensor
from .render import _camera_rays
from .utils import prng


def render_diff(scene: st.Scene, key, nx: int, ny: int, spp: int,
                max_depth: int = 8, device="cuda") -> torch.Tensor:
    """Differentiable render: the (ny, nx, 3) mean over spp samples per
    pixel through trace(mode="scan"). Deterministic in `key` (the JAX
    package's samples, bit for bit, for the same key)."""
    o, d, t, k_trace = _camera_rays(scene, key, nx, ny, spp, device)
    rad = trace(k_trace, o, d, t, scene, max_depth=max_depth, mode="scan")
    return rad.reshape(spp, ny, nx, 3).mean(dim=0)


def l2_loss(scene: st.Scene, target, key, nx: int, ny: int, spp: int,
            max_depth: int = 8, device="cuda") -> torch.Tensor:
    img = render_diff(scene, key, nx, ny, spp, max_depth, device=device)
    return torch.mean((img - leaf_tensor(target, img.device)) ** 2)


def fit_scene_params(scene: st.Scene, target, *, get_params, set_params,
                     key, nx: int, ny: int, spp: int, max_depth: int = 8,
                     steps: int = 100, lr: float = 0.5, postprocess=None,
                     log_fn: Callable[..., None] | None = None,
                     metrics_path: str | None = None, device="cuda"):
    """Inverse rendering over any differentiable parameter subset:
    torch.optim.Adam(lr) on the pixel L2 loss w.r.t. the array
    `get_params(scene)` returns (made a float32 tensor on `device`).
    `set_params(scene, p)` writes a tensor back (dataclasses.replace);
    `postprocess` projects the parameters after each update (e.g. a clamp
    at 0). Step i renders with the key fold_in(key, i). Returns (fitted
    scene, final loss); the fitted scene holds the parameters as a CPU
    tensor.

    log_fn(step, loss, grad_norm) is called per step (two-argument
    callbacks get (step, loss)); metrics_path appends one JSON line per
    step with {step, loss, grad_norm}."""
    dev = torch.device(device)
    params = leaf_tensor(get_params(scene), dev).detach().clone()
    params.requires_grad_(True)
    opt = torch.optim.Adam([params], lr=lr)
    legacy_log = (log_fn is not None
                  and len(inspect.signature(log_fn).parameters) < 3)
    want_gnorm = (log_fn is not None and not legacy_log) or metrics_path
    loss = None
    for step in range(steps):
        opt.zero_grad()
        loss = l2_loss(set_params(scene, params), target,
                       prng.fold_in(key, step), nx, ny, spp, max_depth,
                       device=dev)
        loss.backward()
        # the float() is a host sync: paid only when a consumer asked
        gnorm = float(params.grad.norm()) if want_gnorm else 0.0
        opt.step()
        if postprocess is not None:
            with torch.no_grad():
                params.copy_(postprocess(params))
        loss = loss.detach()
        if log_fn is not None:
            if legacy_log:
                log_fn(step, float(loss))
            else:
                log_fn(step, float(loss), gnorm)
        if metrics_path:
            with open(metrics_path, "a") as mf:
                mf.write(json.dumps({"step": step, "loss": float(loss),
                                     "grad_norm": gnorm}) + "\n")
    return set_params(scene, params.detach().cpu()), float(loss)


def _with_colors(scene: st.Scene, colors) -> st.Scene:
    return dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, color=colors))


def fit_texture_colors(scene: st.Scene, target, *, key, nx: int, ny: int,
                       spp: int, max_depth: int = 8, steps: int = 100,
                       lr: float = 0.5,
                       log_fn: Callable[..., None] | None = None,
                       metrics_path: str | None = None, device="cuda"):
    """Inverse-rendering demo: fit the texture colour table to a target
    image (fit_scene_params on textures.color, clamped at 0). Returns
    (fitted scene, final loss)."""
    return fit_scene_params(
        scene, target, get_params=lambda sc: sc.textures.color,
        set_params=_with_colors,
        postprocess=lambda p: torch.clamp_min(p, 0.0),
        key=key, nx=nx, ny=ny, spp=spp, max_depth=max_depth, steps=steps,
        lr=lr, log_fn=log_fn, metrics_path=metrics_path, device=device)
