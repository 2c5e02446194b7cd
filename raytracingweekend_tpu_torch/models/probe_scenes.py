"""Builder scenes that exercise kernel paths the library's scenes leave out.

Each function takes a builder module `bm` and its scene-types module `st`,
so the same scene can be built by this package and by any package with the
same builder interface, and the two compared. The card tests, the CPU
tests and `chip_smoke.py` use them.
"""
import numpy as np

from ..utils.detrng import MinStd


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


def large_mixed_scene(bm, st, n=60, textured=True, moving=False,
                      aspect=1.5):
    """random_balls_large's n x n grid of jittered balls (the same minstd
    draws; n = 60 gives 3605 spheres, n = 120 14405) with book-2 features
    on it, so that a scene past 512 spheres runs the cluster-culled sweep
    together with rects, lights, media and textures: a checker ground
    (`textured`; else constant 0.5), a rect area light in the lights list
    (one-sample MIS), a small emissive sphere among the balls, and an
    isotropic constant-medium sphere. With `moving` the diffuse balls move
    as random_balls' do, center1 = center + (0, 0.5 u, 0) over [0, 1].
    The draws come from a default-seeded MinStd, whose stream is the one
    every package's scenes draw (utils/detrng.py)."""
    b = bm.SceneBuilder()
    eng = MinStd()
    half = n // 2
    ground = (b.checker(b.constant((0.2, 0.3, 0.1)),
                        b.constant((0.9, 0.9, 0.9)))
              if textured else b.constant((0.5, 0.5, 0.5)))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(ground))
    for a in range(-half, half):
        for bb in range(-half, half):
            choose_mat = eng.uniform()
            uz = eng.uniform()
            ux = eng.uniform()
            center = (a + 0.9 * ux, 0.2, bb + 0.9 * uz)
            if choose_mat < 0.8:
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
    lamp = b.diffuse_light((4.0, 4.0, 4.0))
    b.add_light(b.rect("xz", -3.0, 3.0, -3.0, 3.0, 6.0, lamp))
    b.sphere((2.0, 0.5, 2.0), 0.3, lamp)
    b.constant_medium_sphere((2.0, 1.0, -2.0), 0.8, 0.5,
                             b.isotropic((0.9, 0.9, 0.9)))
    b.camera((13, 4, 3), (0, 0, 0), (0, 1, 0), 30.0, aspect, 0.0, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="large_mixed")


def rect_tie_scene(bm, st):
    """Two coplanar rects that cover the same square, so every camera ray
    that reaches the square meets both at the same t: row 1 (red), moved
    into place by a translate along x (transform group 1, whose
    object-space ray keeps the world z and 1 / d_z), and row 2 (green),
    untransformed (group 0, with row 0, a floor). The winner is the first
    row with the strictly smallest t, row 1, although the surfaces kernels
    test group 0's rects first (ops/megakernel.py rect_runs)."""
    b = bm.SceneBuilder()
    b.rect("xz", -4.0, 4.0, -4.0, 4.0, -2.0,
           b.lambertian(b.constant((0.5, 0.5, 0.5))))
    b.rect("xy", -1.5, 0.5, -1.0, 1.0, 0.0,
           b.lambertian(b.constant((0.8, 0.1, 0.1))),
           translate=(0.5, 0.0, 0.0))
    b.rect("xy", -1.0, 1.0, -1.0, 1.0, 0.0,
           b.lambertian(b.constant((0.1, 0.8, 0.1))))
    b.camera((0.3, 0.2, 4.0), (0.0, 0.0, 0.0), (0, 1, 0), 40.0, 1.0, 0.0,
             10.0)
    return b.build(background=st.BG_GRADIENT, name="rect_tie")
