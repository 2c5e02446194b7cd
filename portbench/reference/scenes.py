"""The benchmark's own copy of the two scene generators its cells render
(reference: RayTracingWeekend/Scene/scene.h:98-174 and :176-249). The
benchmark builds the scene once from the configuration and hands the same
object to the program and to the reference."""
from __future__ import annotations

import math

from . import scene_types as st
from .builder import SceneBuilder
from .detrng import MinStd


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


SCENES = {"random_balls": random_balls_scene,
          "cornell_box": cornell_box_scene}


def make_scene(name: str, aspect: float, **kw) -> st.Scene:
    """The scene `name` at image aspect `aspect`; raises KeyError on a
    scene the benchmark does not generate."""
    return SCENES[name](aspect, **kw)
