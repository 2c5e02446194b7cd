"""The reference scene library on SceneBuilder
(reference: RayTracingWeekend/Scene/scene.h:42-249).

The port's counterpart of raytracingweekend_tpu/models/scenes.py: the
book-1 scenes, the two large-S stress scenes, the Cornell boxes (rects,
lights, media) and the texture scenes (checker, Perlin noise, the earth
image). A scene of the JAX library that a later slice of the port brings
is listed in LATER_SCENES and raises NotImplementedError naming its
ROADMAP item.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np

from . import scene_types as st
from .builder import SceneBuilder
from ..utils import image as image_mod
from ..utils.detrng import MinStd

SCENES: Dict[str, Callable[..., st.Scene]] = {}

# Scenes of the JAX library that later slices of the port bring (none
# left): name -> the ROADMAP item that brings it.
LATER_SCENES: Dict[str, str] = {}


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


@register("light_sample")
def light_sample(aspect: float) -> st.Scene:
    """Perlin spheres, a sphere light and a rect light under a thin lens
    (Scene/scene.h:42-70). The reference registers no lights list here
    (scene.h:50-59 fills `objects` only), so MIS falls back to the cosine
    pdf."""
    b = SceneBuilder()
    pertext = b.noise(4.0)
    four = b.constant((4.0, 4.0, 4.0))
    lam = b.lambertian(pertext)
    light = b.diffuse_light(four)

    b.sphere((0, -1000, 0), 1000.0, lam)
    b.sphere((0, 2, 0), 2.0, lam)
    b.sphere((0, 7, 0), 2.0, light)
    b.rect("xy", 3.0, 5.0, 1.0, 3.0, -2.0, light)

    lookfrom = (24.0, 5.0, 5.0)
    lookat = (0.0, 3.0, 0.0)
    dist = math.dist(lookfrom, lookat)
    b.camera(lookfrom, lookat, (0, 1, 0), 20.0, aspect, 0.2, dist, 0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="light_sample")


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


@register("random_balls_large")
def random_balls_large(aspect: float, n: int = 60,
                       use_bvh: bool = False) -> st.Scene:
    """Stress scene beyond the reference's scale: an n x n grid of
    jittered diffuse / metal / glass balls (~n^2 spheres; 3604 live at the
    default n = 60), the three big balls and the ground, on the
    default-seeded minstd stream. `use_bvh=True` adds the sphere BVH
    (ops/bvh.py), which routes the scene to the wavefront path."""
    b = SceneBuilder()
    eng = MinStd()
    half = n // 2
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.constant((0.5, 0.5, 0.5))))
    for a in range(-half, half):
        for bb in range(-half, half):
            choose_mat = eng.uniform()
            uz = eng.uniform()   # z before x, as in random_balls
            ux = eng.uniform()
            center = (a + 0.9 * ux, 0.2, bb + 0.9 * uz)
            if choose_mat < 0.8:
                color = (eng.uniform() * eng.uniform(),
                         eng.uniform() * eng.uniform(),
                         eng.uniform() * eng.uniform())
                b.sphere(center, 0.2, b.lambertian(b.constant(color)))
            elif choose_mat < 0.95:
                color = (0.5 * (1 + eng.uniform()),
                         0.5 * (1 + eng.uniform()),
                         0.5 * (1 + eng.uniform()))
                b.sphere(center, 0.2, b.metal(color, 0.5 * eng.uniform()))
            else:
                b.sphere(center, 0.2, b.dielectric(1.5))
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian(b.constant((0.4, 0.2, 0.1))))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    b.camera((13, 4, 3), (0, 0, 0), (0, 1, 0), 30.0, aspect, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="random_balls_large",
                   use_bvh=use_bvh)


@register("random_balls_huge")
def random_balls_huge(aspect: float) -> st.Scene:
    """The 120 x 120 grid of random_balls_large: 14404 live spheres."""
    return random_balls_large(aspect, n=120)


@register("cornell_box")
def cornell_box_scene(aspect: float, glass_sphere: bool = True,
                      aluminum_box: bool = False) -> st.Scene:
    """Book-3 Cornell box (Scene/scene.h:176-249): walls, the area light
    and the rotated tall box; the short box is the glass sphere that is
    also a light (the active #if 1 at scene.h:219-225).
    `glass_sphere=False` restores the two-box book-2 variant;
    `aluminum_box=True` makes the tall box metal (scene.h:228-231)."""
    b = SceneBuilder()
    red = b.lambertian(b.constant((0.65, 0.05, 0.05)))
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    green = b.lambertian(b.constant((0.12, 0.45, 0.15)))
    light = b.diffuse_light((15.0, 15.0, 15.0))

    b.add_light(b.rect("xz", 213.0, 343.0, 227.0, 332.0, 554.0, light))
    b.rect("yz", 0.0, 555.0, 0.0, 555.0, 555.0, green, flip=True)
    b.rect("yz", 0.0, 555.0, 0.0, 555.0, 0.0, red)
    b.rect("xz", 0.0, 555.0, 0.0, 555.0, 555.0, white, flip=True)
    b.rect("xz", 0.0, 555.0, 0.0, 555.0, 0.0, white)
    b.rect("xy", 0.0, 555.0, 0.0, 555.0, 555.0, white, flip=True)

    if glass_sphere:
        b.add_light(b.sphere((190.0, 90.0, 190.0), 90.0, b.dielectric(1.5)))
    else:
        b.box((0, 0, 0), (165, 165, 165), white, rotate_y=-18.0,
              translate=(130.0, 0.0, 65.0))

    tall_mat = b.metal((0.8, 0.85, 0.88), 0.0) if aluminum_box else white
    b.box((0, 0, 0), (165, 330, 165), tall_mat, rotate_y=15.0,
          translate=(265.0, 0.0, 295.0))

    b.camera((278, 278, -800), (278, 278, 0), (0, 1, 0), 40.0, aspect, 0.0,
             10.0, 0.0, 1.0)
    return b.build(background=st.BG_BLACK, name="cornell_box")


@register("cornell_smoke")
def cornell_smoke_scene(aspect: float) -> st.Scene:
    """Book-2 Cornell box with two smoke boxes (constant_medium,
    hittable.h:420-489; the reference's Volume.png render)."""
    b = SceneBuilder()
    red = b.lambertian(b.constant((0.65, 0.05, 0.05)))
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    green = b.lambertian(b.constant((0.12, 0.45, 0.15)))
    light = b.diffuse_light((7.0, 7.0, 7.0))

    b.add_light(b.rect("xz", 113.0, 443.0, 127.0, 432.0, 554.0, light))
    b.rect("yz", 0.0, 555.0, 0.0, 555.0, 555.0, green, flip=True)
    b.rect("yz", 0.0, 555.0, 0.0, 555.0, 0.0, red)
    b.rect("xz", 0.0, 555.0, 0.0, 555.0, 555.0, white, flip=True)
    b.rect("xz", 0.0, 555.0, 0.0, 555.0, 0.0, white)
    b.rect("xy", 0.0, 555.0, 0.0, 555.0, 555.0, white, flip=True)

    fog = b.isotropic((1.0, 1.0, 1.0))
    smoke = b.isotropic((0.0, 0.0, 0.0))
    b.constant_medium_box((0, 0, 0), (165, 165, 165), 0.01, fog,
                          rotate_y=-18.0, translate=(130.0, 0.0, 65.0))
    b.constant_medium_box((0, 0, 0), (165, 330, 165), 0.01, smoke,
                          rotate_y=15.0, translate=(265.0, 0.0, 295.0))

    b.camera((278, 278, -800), (278, 278, 0), (0, 1, 0), 40.0, aspect, 0.0,
             10.0, 0.0, 1.0)
    return b.build(background=st.BG_BLACK, name="cornell_smoke")


@register("two_perlin_spheres")
def two_perlin_spheres(aspect: float) -> st.Scene:
    """Book-2 marble spheres (noise_texture, texture.h:52-71)."""
    b = SceneBuilder()
    pertext = b.noise(4.0)
    lam = b.lambertian(pertext)
    b.sphere((0, -1000, 0), 1000.0, lam)
    b.sphere((0, 2, 0), 2.0, lam)
    b.camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, aspect, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="two_perlin_spheres")


@register("checker_spheres")
def checker_spheres(aspect: float) -> st.Scene:
    """Book-2 checker ground (checker_texture, texture.h:29-50)."""
    b = SceneBuilder()
    checker = b.checker(b.constant((0.2, 0.3, 0.1)),
                        b.constant((0.9, 0.9, 0.9)))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))
    b.sphere((0, 2, 0), 2.0, b.lambertian(checker))
    b.camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, aspect, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="checker_spheres")


def _earth_pixels(image_path: Optional[str] = None) -> np.ndarray:
    """The texels of `image_path` (`utils.image.load_image`), else the JAX
    package's procedural stand-in (latitude bands, 256x512), which is also
    what the JAX package renders while the repo holds no earth.jpg. The
    port reads no JPEG (ROADMAP Queue 1, Image I/O)."""
    if image_path:
        return image_mod.load_image(image_path)
    v = np.linspace(0.0, 1.0, 256)[:, None]
    u = np.linspace(0.0, 1.0, 512)[None, :]
    land = (np.sin(u * 21.0) * np.sin(v * 13.0)) > 0.3
    return np.where(land[..., None],
                    np.array([0.2, 0.5, 0.2]),
                    np.array([0.1, 0.2, 0.6]))


@register("earth")
def earth_scene(aspect: float, image_path: Optional[str] = None) -> st.Scene:
    """Book-2 image-texture globe; `image_path` names the texels, e.g.
    tools/reference_oracle/earth.rtwi, the reference oracle's own."""
    b = SceneBuilder()
    tex = b.image(_earth_pixels(image_path))
    b.sphere((0, 0, 0), 2.0, b.lambertian(tex))
    b.camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, aspect, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="earth")


@register("earth_rect")
def earth_rect_scene(aspect: float,
                     image_path: Optional[str] = None) -> st.Scene:
    """The earth image on an axis rect (planar uv, hittable.h:160-172) and
    on a sphere beside it, over a grey ground sphere."""
    b = SceneBuilder()
    tex = b.image(_earth_pixels(image_path))
    b.rect("xy", -3.0, 3.0, -1.5, 1.5, -1.0, b.lambertian(tex))
    b.sphere((0, 0, 2.0), 1.0, b.lambertian(tex))
    b.sphere((0, -101.8, 0), 100.0,
             b.lambertian(b.constant((0.6, 0.6, 0.6))))
    b.camera((0, 0.5, 9), (0, 0, 0), (0, 1, 0), 40.0, aspect, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="earth_rect")
