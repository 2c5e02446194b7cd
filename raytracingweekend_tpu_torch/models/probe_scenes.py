"""Builder scenes that exercise kernel paths the library's scenes leave out.

Each function takes a builder module `bm` and its scene-types module `st`,
so the same scene can be built by this package and by any package with the
same builder interface, and the two compared. The card tests, the CPU
tests and `chip_smoke.py` use them.
"""
import numpy as np


def shutter_scene(bm, st):
    """Spheres whose shutters differ: a ball moving in y over [0.25, 0.75],
    one moving in x and z over [0, 1], and static metal, glass and ground.
    The plan's `uniform_time` is then false, so the sweep takes each slot's
    own motion fraction."""
    b = bm.SceneBuilder()
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.constant((0.5, 0.5, 0.5))))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.constant((0.4, 0.2, 0.1))),
             center1=(0, 1.5, 0), time0=0.25, time1=0.75)
    b.sphere((-4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.2))
    b.sphere((4, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((2.0, 0.4, 2.0), 0.4, b.lambertian(b.constant((0.2, 0.7, 0.3))),
             center1=(2.6, 0.4, 1.5), time0=0.0, time1=1.0)
    b.camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, 1.0, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="shutter")


def nested_scene(bm, st):
    """Instancing and media beyond the Cornell scenes: a rect and a box
    under a nested `transform=` around their own rotate_y / translate, a
    translated sphere light, a rotated constant_medium_sphere and an
    untransformed constant_medium_box."""
    b = bm.SceneBuilder()
    T = bm.Transform
    outer = T.translate((10.0, -2.0, 5.0)) @ T.rotate_y(30.0)
    white = b.lambertian(b.constant((0.7, 0.7, 0.7)))
    lamp = b.diffuse_light((4.0, 4.0, 4.0))
    b.rect("xz", -50.0, 50.0, -50.0, 50.0, 0.0, white)
    b.add_light(b.rect("xy", 1.0, 3.0, 2.0, 4.0, -6.0, lamp, flip=True,
                       rotate_y=20.0, translate=(1.0, 2.0, 3.0),
                       transform=outer))
    b.box((0, 0, 0), (2, 3, 2), white, rotate_y=-40.0,
          translate=(-3.0, 0.0, 1.0), transform=outer)
    b.add_light(b.sphere((0.5, 4.0, -1.0), 0.75, lamp,
                         translate=(0.0, 1.0, 0.0), transform=outer))
    b.sphere((2.0, 1.0, 2.0), 1.0, b.dielectric(1.5))
    b.constant_medium_sphere((0.0, 1.0, 0.0), 1.5, 0.2,
                             b.isotropic((0.9, 0.8, 0.7)), rotate_y=45.0,
                             translate=(-4.0, 0.5, -2.0), transform=outer)
    b.constant_medium_box((4, 0, -4), (6, 2, -2), 0.05,
                          b.isotropic((0.3, 0.3, 0.3)))
    b.camera((0, 5, 20), (0, 1, 0), (0, 1, 0), 40.0, 1.0, 0.0, 10.0)
    return b.build(background=st.BG_BLACK, name="nested")


def texture_mix_scene(bm, st):
    """Every texture lane of kernel K4 in one scene: a checker ground
    sphere, a marble sphere, smooth and turbulent noise on rects, a checker
    rect, a marble medium and an image-textured medium (sampled at
    uv = (0, 0))."""
    b = bm.SceneBuilder()
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.checker(
        b.constant((0.2, 0.3, 0.1)), b.constant((0.9, 0.9, 0.9)))))
    b.sphere((0, 1, 0), 1.0, b.lambertian(b.noise(4.0, st.NOISE_MARBLE)))
    b.rect("xy", -3.0, 3.0, 0.0, 3.0, -2.0,
           b.lambertian(b.noise(3.0, st.NOISE_SMOOTH)))
    b.rect("yz", 0.0, 3.0, -2.0, 2.0, -3.0,
           b.lambertian(b.noise(2.0, st.NOISE_TURB)))
    b.rect("yz", 0.0, 2.0, -2.0, 2.0, 3.0, b.lambertian(b.checker(
        b.constant((0.8, 0.1, 0.1)), b.constant((0.1, 0.1, 0.8)))),
        flip=True)
    b.constant_medium_sphere((1.8, 0.8, 1.2), 0.7, 1.5,
                             b.isotropic(b.noise(3.0, st.NOISE_MARBLE)))
    ramp = np.broadcast_to(np.linspace(0.1, 0.9, 16)[:, None, None],
                           (16, 32, 3))
    b.constant_medium_box((-2.5, 0.0, 0.5), (-1.3, 1.2, 1.7), 1.0,
                          b.isotropic(b.image(ramp)))
    b.camera((6, 2, 5), (0, 1, 0), (0, 1, 0), 40.0, 1.0, 0.0, 10.0)
    return b.build(background=st.BG_GRADIENT, name="texture_mix")
