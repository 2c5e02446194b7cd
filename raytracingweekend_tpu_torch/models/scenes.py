"""The reference scene library on SceneBuilder
(reference: RayTracingWeekend/Scene/scene.h:42-249).

The port's counterpart of raytracingweekend_tpu/models/scenes.py. This
slice carries the two book-1 scenes; every other scene of the JAX library
raises NotImplementedError naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

from . import scene_types as st
from .builder import SceneBuilder
from ..utils.detrng import MinStd

SCENES: Dict[str, Callable[..., st.Scene]] = {}

# Scenes of the JAX library that later slices of the port bring.
LATER_SCENES = {
    "light_sample": "ROADMAP Queue 1 item 5 (K2 rects/lights, K4 textures)",
    "cornell_box": "ROADMAP Queue 1 item 5 (K2 rects, lights and MIS)",
    "cornell_smoke": "ROADMAP Queue 1 item 5 (K3 constant media)",
    "two_perlin_spheres": "ROADMAP Queue 1 item 5 (K4 textures)",
    "checker_spheres": "ROADMAP Queue 1 item 5 (K4 textures)",
    "earth": "ROADMAP Queue 1 item 5 (K4 textures)",
    "earth_rect": "ROADMAP Queue 1 item 5 (K2 rects, K4 textures)",
    "random_balls_large": "ROADMAP Queue 1 item 5 (K5 large-S culling)",
    "random_balls_huge": "ROADMAP Queue 1 item 5 (K5 large-S culling)",
}


def register(name):
    def deco(fn):
        SCENES[name] = fn
        return fn
    return deco


def make_scene(name: str, aspect: float, **kw) -> st.Scene:
    if name in LATER_SCENES:
        raise NotImplementedError(
            f"scene {name!r} is not ported yet: {LATER_SCENES[name]}")
    return SCENES[name](aspect, **kw)


@register("dielectric")
def dielectric_scene(aspect: float) -> st.Scene:
    """Book-1 glass trio with the hollow negative-radius ball
    (Scene/scene.h:72-96)."""
    b = SceneBuilder()
    b.sphere((0, 0, -1), 0.5, b.lambertian(b.constant((0.1, 0.2, 0.5))))
    b.sphere((0, -100.5, -1), 100.0,
             b.lambertian(b.constant((0.8, 0.8, 0.0))))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.0))
    glass = b.dielectric(1.5)
    b.sphere((-1, 0, -1), 0.5, glass)
    b.sphere((-1, 0, -1), -0.45, glass)  # hollow shell (scene.h:85-86)
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 120.0, aspect, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="dielectric")


@register("random_balls")
def random_balls_scene(aspect: float, moving: bool = True) -> st.Scene:
    """Book-1 final scene: ~480 spheres on a 22x22 grid with motion blur on
    the diffuse balls (Scene/scene.h:98-174), laid out by the deterministic
    minstd stream of the default-seeded engine at scene.h:103-104."""
    b = SceneBuilder()
    eng = MinStd()
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.constant((0.5, 0.5, 0.5))))

    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose_mat = eng.uniform()
            # g++ evaluates the vec3 constructor's arguments RIGHT TO LEFT
            # (scene.h:116): z consumes its uniform before x does.
            uz = eng.uniform()
            ux = eng.uniform()
            center = (a + 0.9 * ux, 0.2, bb + 0.9 * uz)
            dx = center[0] - 4.0
            dz = center[2] - 0.0
            if math.sqrt(dx * dx + (center[1] - 0.2) ** 2 + dz * dz) <= 0.9:
                continue
            if choose_mat < 0.8:  # diffuse, moving (scene.h:119-139)
                color = (eng.uniform() * eng.uniform(),
                         eng.uniform() * eng.uniform(),
                         eng.uniform() * eng.uniform())
                lam = b.lambertian(b.constant(color))
                if moving:
                    c1 = (center[0], center[1] + 0.5 * eng.uniform(),
                          center[2])
                    b.sphere(center, 0.2, lam, center1=c1, time0=0.0,
                             time1=1.0)
                else:
                    b.sphere(center, 0.2, lam)
            elif choose_mat < 0.95:  # metal (scene.h:142-150)
                color = (0.5 * (1 + eng.uniform()),
                         0.5 * (1 + eng.uniform()),
                         0.5 * (1 + eng.uniform()))
                fuzz = 0.5 * eng.uniform()
                b.sphere(center, 0.2, b.metal(color, fuzz))
            else:  # glass (scene.h:151-156)
                b.sphere(center, 0.2, b.dielectric(1.5))

    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian(b.constant((0.4, 0.2, 0.1))))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))

    b.camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, aspect, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="random_balls")
