"""Kernel K7's plain version and the port's wavefront geometry against the
JAX package.

K7 (ops/intersect.py, csrc/intersect.cu) replaces
pallas_intersect.hit_spheres_pallas. Its plain version runs here on the
CPU and is held to the JAX kernel in interpret mode (called directly, no
environment switch) and to geometry._hit_spheres_xla on the same rays:
both write XLA:CPU's FMAs out, so against the interpret-mode kernel the
result is asserted bit for bit; against the XLA formulation (other
expressions, other contractions) indices must agree on >= 99.9% of
hitting rays and t to rtol 1e-4 where they do. The rect, medium and
full-scene closest hits are held to the JAX functions on the Cornell
scenes (kind and index on >= 99.9% of rays, p / normal / uv to rtol 1e-4),
and the BVH to the brute-force hit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import bvh as jbvh  # noqa: E402
from raytracingweekend_tpu.ops import camera as jcamera  # noqa: E402
from raytracingweekend_tpu.ops import geometry as jgeo  # noqa: E402
from raytracingweekend_tpu.ops import pallas_intersect as jpi  # noqa: E402
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import camera as tcamera  # noqa: E402
from raytracingweekend_tpu_torch.ops import geometry as tgeo  # noqa: E402
from raytracingweekend_tpu_torch.ops import intersect as tint  # noqa: E402
from raytracingweekend_tpu_torch.ops.packing import device_scene  # noqa: E402
from raytracingweekend_tpu_torch.utils import prng  # noqa: E402

torch.set_num_threads(2)

N = 4096
MIN_SAME = 0.999
RTOL = 1e-4
# scene -> (make_scene keywords, box the secondary rays start in)
SCENES = {"random_balls": ({}, (-8.0, 0.05, -6.0, 8.0, 2.0, 6.0)),
          "dielectric": ({}, (-2.0, -0.5, -2.0, 2.0, 1.0, 0.5)),
          "cornell_box": ({}, (1.0, 1.0, 1.0, 554.0, 554.0, 554.0)),
          "cornell_smoke": ({}, (1.0, 1.0, 1.0, 554.0, 554.0, 554.0)),
          "random_balls_large": ({"n": 20}, (-10.0, 0.05, -10.0, 10.0, 2.0,
                                             10.0))}


def _words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


def _scenes(name):
    kw, _ = SCENES[name]
    return jscenes.make_scene(name, 1.5, **kw), make_scene(name, 1.5, **kw)


def _rays(name, jscene, seed=0):
    """N rays as numpy: half camera rays (the JAX camera on one key), half
    from points inside the scene toward random directions; times U[0, 1)."""
    rng = np.random.default_rng(seed)
    h = N // 2
    k = jax.random.key(seed)
    s = jnp.asarray(rng.uniform(size=h), jnp.float32)
    t = jnp.asarray(rng.uniform(size=h), jnp.float32)
    o1, d1, tm1 = (np.asarray(x) for x in jcamera.get_rays(
        k, jscene.camera, s, t))
    lo, hi = np.split(np.asarray(SCENES[name][1], np.float32), 2)
    o2 = (lo + (hi - lo) * rng.uniform(size=(h, 3))).astype(np.float32)
    d2 = rng.normal(size=(h, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    tm2 = rng.uniform(size=h).astype(np.float32)
    return (np.concatenate([o1, o2]), np.concatenate([d1, d2.astype(
        np.float32)]), np.concatenate([tm1, tm2]))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_get_rays_matches_jax():
    """Camera rays from one key: the lens and shutter draws are bitwise
    JAX's; origins and directions to float32 round-off."""
    js, ts = _scenes("random_balls")
    rng = np.random.default_rng(1)
    s = rng.uniform(size=512).astype(np.float32)
    t = rng.uniform(size=512).astype(np.float32)
    k = jax.random.key(4)
    jo, jd, jt = (np.asarray(x) for x in jcamera.get_rays(
        k, js.camera, jnp.asarray(s), jnp.asarray(t)))
    to, td, tt = tcamera.get_rays(_words(k), device_scene(ts, "cpu").camera,
                                  *_t(s, t))
    assert np.array_equal(jt, tt.numpy())
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["random_balls", "cornell_box",
                                  "random_balls_large"])
def test_pack_spheres_is_the_jax_table(name):
    """The port's 12-lane table holds the JAX kernel's lanes bitwise."""
    js, ts = _scenes(name)
    jt = np.asarray(jpi.pack_spheres(js.spheres))
    tt = tint.pack_spheres(ts.spheres)
    cols = {tint.K_CX: jpi._CX, tint.K_CY: jpi._CY, tint.K_CZ: jpi._CZ,
            tint.K_R2: jpi._R2, tint.K_DCX: jpi._DCX, tint.K_DCY: jpi._DCY,
            tint.K_DCZ: jpi._DCZ, tint.K_T0: jpi._T0, tint.K_IDT: jpi._IDT,
            tint.K_ACT: jpi._ACT}
    for ours, theirs in cols.items():
        assert tt[:, ours].tobytes() == jt[:, theirs].tobytes(), ours


@pytest.mark.parametrize("name", ["random_balls", "dielectric",
                                  "cornell_box", "random_balls_large"])
def test_k7_plain_version_matches_jax_kernel(name):
    """The plain version against the JAX kernel in interpret mode (bit for
    bit) and against the XLA formulation (the gates above)."""
    js, ts = _scenes(name)
    o, d, tm = _rays(name, js)
    moving = js.has_moving_spheres
    rays = jpi.pack_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    jt, ji = (np.asarray(x) for x in jpi.hit_spheres_pallas(
        rays, jpi.pack_spheres(js.spheres), moving=moving, t_min=0.001,
        tile=512, interpret=True))
    xt, xi = (np.asarray(x) for x in jgeo._hit_spheres_xla(
        *(jnp.asarray(a) for a in (o, d, tm)), 0.001, js.spheres, moving))
    table = torch.from_numpy(tint.pack_spheres(ts.spheres))
    bt, bi = tint.hit_spheres_reference(*_t(o, d, tm), table, moving)
    bt, bi = bt.numpy(), bi.numpy()
    hit = jt < 1e30
    assert 0.02 < hit.mean() < 1.0
    # bit for bit against the interpret-mode kernel (its index on hits)
    assert bt.tobytes() == jt.tobytes()
    assert np.array_equal(bi[hit], ji[hit])
    # the XLA formulation
    xhit = xt < 1e30
    same = bi[xhit] == xi[xhit]
    assert same.mean() >= MIN_SAME, same.mean()
    np.testing.assert_allclose(bt[xhit][same], xt[xhit][same], rtol=RTOL)
    # geometry.hit_spheres takes the plain version for CPU tensors
    dt, di = tgeo.hit_spheres(*_t(o, d, tm), device_scene(ts, "cpu"))
    assert torch.equal(dt, torch.from_numpy(bt))
    assert torch.equal(di, torch.from_numpy(bi))


def test_k7_plain_version_ties_blocks_and_inactive_rows():
    """First slot wins a tie, also across the plain version's 256-slot
    blocks; inactive rows never hit; a moving row with time1 == time0
    (1/dt = 0) stays at centre0."""
    S = 600
    tab = np.zeros((S, tint.LANES), np.float32)
    tab[:, tint.K_CZ] = 5.0
    tab[:, tint.K_R2] = 1.0
    tab[:, tint.K_ACT] = 1.0
    tab[:, tint.K_DCX] = 3.0          # motion with 1/dt = 0: no effect
    tab[:10, tint.K_ACT] = 0.0        # rows 0-9 inactive
    o = np.zeros((3, 3), np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (3, 1))
    d[2] = (0.0, 1.0, 0.0)            # misses everything
    tm = np.asarray([0.0, 0.7, 0.3], np.float32)
    for moving in (False, True):
        bt, bi = tint.hit_spheres_reference(*_t(o, d, tm),
                                            torch.from_numpy(tab), moving)
        assert bt[:2].tolist() == [4.0, 4.0] and bi[:2].tolist() == [10, 10]
        assert bt[2].item() == float(np.float32(tint.BIG))
    tab[300, tint.K_CZ] = 4.5         # a closer slot in the second block
    bt, bi = tint.hit_spheres_reference(*_t(o, d, tm), torch.from_numpy(tab),
                                        False)
    assert bi[:2].tolist() == [300, 300] and bt[0].item() == 3.5


def test_k7_kernel_refuses_cpu_tensors():
    o = torch.zeros((4, 3))
    table = torch.zeros((8, tint.LANES))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tint.hit_spheres_kernel(o, o, torch.zeros(4), table, False)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            device_scene(make_scene("dielectric", 1.0), "cuda")


def _close_pair(a, b):
    return np.isclose(a, b, rtol=RTOL, atol=RTOL).all(axis=-1) if a.ndim > 1 \
        else np.isclose(a, b, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke"])
def test_rect_and_medium_hits_match_jax(name):
    js, ts = _scenes(name)
    ds = device_scene(ts, "cpu")
    o, d, tm = _rays(name, js, seed=2)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jt, ji = (np.asarray(x) for x in jgeo.hit_rects(
        jo, jd, 0.001, js.rects, js.has_rect_transforms))
    tt, ti = tgeo.hit_rects(*_t(o, d), 0.001, ds.rects,
                            ts.has_rect_transforms)
    hit = jt < 1e30
    assert hit.mean() > 0.5
    same = ti.numpy()[hit] == ji[hit]
    assert same.mean() >= MIN_SAME
    np.testing.assert_allclose(tt.numpy()[hit][same], jt[hit][same],
                               rtol=RTOL)
    if not js.has_media:
        return
    k = jax.random.key(8)
    mt, mi = (np.asarray(x) for x in jgeo.hit_media(k, jo, jd, 0.001,
                                                    js.media))
    pt, pi_ = tgeo.hit_media(_words(k), *_t(o, d), 0.001, ds.media)
    mhit = mt < 1e30
    assert mhit.mean() > 0.05
    assert ((pt.numpy() < 1e30) == mhit).mean() >= MIN_SAME
    same = pi_.numpy()[mhit] == mi[mhit]
    assert same.mean() >= MIN_SAME
    np.testing.assert_allclose(pt.numpy()[mhit][same], mt[mhit][same],
                               rtol=RTOL)


@pytest.mark.parametrize("name", ["cornell_box", "cornell_smoke",
                                  "random_balls"])
def test_closest_hit_matches_jax(name):
    """The full-scene closest hit with the winner's attributes, uv forced
    on (the full hit_record): kind, index and material on >= 99.9% of
    rays; p, normal and uv to rtol 1e-4 there."""
    js, ts = _scenes(name)
    o, d, tm = _rays(name, js, seed=3)
    k = jax.random.key(12)
    jh = jgeo.closest_hit(k, *(jnp.asarray(a) for a in (o, d, tm)), js,
                          want_uv=True)
    th = tgeo.closest_hit(_words(k), *_t(o, d, tm), device_scene(ts, "cpu"),
                          want_uv=True)
    assert (th.hit.numpy() == np.asarray(jh.hit)).mean() >= MIN_SAME
    both = th.hit.numpy() & np.asarray(jh.hit)
    assert both.mean() > 0.3
    mat_same = th.mat.numpy()[both] == np.asarray(jh.mat)[both]
    sattr_same = np.all(th.sattr.numpy()[both] == np.asarray(jh.sattr)[both],
                        axis=-1)
    same = mat_same & sattr_same
    assert same.mean() >= MIN_SAME
    for field in ("t", "p", "normal", "u", "v"):
        a = getattr(th, field).numpy()[both][same]
        b = np.asarray(getattr(jh, field))[both][same]
        ok = _close_pair(a, b)
        assert ok.mean() >= MIN_SAME, (field, ok.mean())


def test_bvh_nodes_bitwise_and_hit_equals_brute_force():
    """random_balls_large(n=10, use_bvh=True): the node arrays are the JAX
    package's bit for bit, and the traversal's hit is the brute-force
    table's (same t; same sphere wherever the t is unique)."""
    js = jscenes.make_scene("random_balls_large", 1.5, n=10, use_bvh=True)
    ts = make_scene("random_balls_large", 1.5, n=10, use_bvh=True)
    for f in ("bbox_min", "bbox_max", "skip", "first", "count", "order"):
        a, b = np.asarray(getattr(js.bvh, f)), getattr(ts.bvh, f)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f
        assert a.tobytes() == b.tobytes(), f
    o, d, tm = _rays("random_balls_large", js, seed=5)
    ds = device_scene(ts, "cpu")
    from raytracingweekend_tpu_torch.ops import bvh as tbvh
    bt, bi = tbvh.hit_spheres_bvh(*_t(o, d, tm), 0.001, ds.spheres, ds.bvh,
                                  ts.has_moving_spheres)
    ft, fi = tint.hit_spheres_reference(
        *_t(o, d, tm), torch.from_numpy(tint.pack_spheres(ts.spheres)),
        ts.has_moving_spheres)
    hit = ft.numpy() < 1e30
    assert hit.mean() > 0.3
    assert np.array_equal(bt.numpy() < 1e30, hit)
    np.testing.assert_allclose(bt.numpy()[hit], ft.numpy()[hit], rtol=RTOL)
    assert (bi.numpy()[hit] == fi.numpy()[hit]).mean() >= MIN_SAME
    # and the JAX traversal agrees
    jt, ji = jbvh.hit_spheres_bvh(*(jnp.asarray(a) for a in (o, d, tm)),
                                  0.001, js.spheres, js.bvh,
                                  js.has_moving_spheres)
    assert (np.asarray(ji)[hit] == bi.numpy()[hit]).mean() >= MIN_SAME
