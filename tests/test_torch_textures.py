"""The port's texture path (kernel K4: checker, Perlin noise and image
textures on spheres, rects and media) against the JAX package.

On the CPU the port runs its plain PyTorch version; the JAX side runs as
its own tests run it (the tape-mode kernel in interpret mode, the XLA
replay).

- The noise helpers and the polynomial uv helpers are held to the JAX
  kernel's own (`mk._perlin_noise`, `_turb`, `_marble`, `_atan2`, `_asin`)
  and to the exact-table `ops/noise.noise`.
- Exact-spp mode is held to the JAX tape decision by decision (>= 99% of
  pooled lanes), and the JAX replay fed the port's tape reproduces the
  port's image. Radiance is held to the replay gate of tests/test_mega_grad
  (rtol 1e-3, atol 5e-5) on checker and image scenes. Noise scenes use that
  file's Perlin gate (rtol 0.1, atol 4e-3, mean abs error < 1e-4): marble
  is sin(scale z + 10 turb(p)), so an ulp of a hit point grows tenfold, and
  the JAX kernel's gradient table is a bf16 hi/lo reconstruction (within
  2^-17 relative of the port's exact float32 table).
- render() passes the blockwise golden gate of tests/test_golden.py on
  light_sample and on the earth scenes built on the oracle's own texels
  (tools/reference_oracle/earth.rtwi).
"""
import functools
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from raytracingweekend_tpu.models import builder as jbuilder  # noqa: E402
from raytracingweekend_tpu.models import scene_types as jst  # noqa: E402
from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import mega_grad as mg  # noqa: E402
from raytracingweekend_tpu.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu.ops import noise as jnoise  # noqa: E402
from raytracingweekend_tpu_torch import render as trender  # noqa: E402
from raytracingweekend_tpu_torch.models import builder as tbuilder  # noqa: E402
from raytracingweekend_tpu_torch.models import scene_types as tst  # noqa: E402
from raytracingweekend_tpu_torch.models.probe_scenes import (  # noqa: E402
    texture_mix_scene)
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from raytracingweekend_tpu_torch.ops import noise as tnoise  # noqa: E402
from raytracingweekend_tpu_torch.utils.config import RenderConfig  # noqa: E402

# two intra-op threads per xdist worker (see test_torch_megakernel.py)
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTWI = os.path.join(REPO, "tools", "reference_oracle", "earth.rtwi")
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
NX = NY = 16
SPP, DEPTH = 4, 5
RTOL, ATOL = 1e-3, 5e-5
# JAX keys per scene: four on the cheap scenes, two on the Perlin ones
# (~11 s a key for the JAX tape kernel in interpret mode)
KEYS = {"checker_spheres": (3, 4, 5, 6), "earth": (3, 4, 5, 6),
        "earth_rect": (3, 4, 5, 6), "two_perlin_spheres": (3, 4),
        "texture_mix": (3, 4)}
NOISE_SCENES = ("two_perlin_spheres", "texture_mix")


def _points(n=4096, seed=0, lo=-20.0, hi=20.0):
    p = np.random.default_rng(seed).uniform(lo, hi, (3, n)).astype(
        np.float32)
    return p, [torch.from_numpy(c) for c in p]


def _exact_tables():
    perm, ranvec = tnoise.noise_tables("cpu")
    return perm, ranvec


def test_noise_tables_bitwise():
    for a, b in zip(jnoise.NOISE_TABLES, tnoise.NOISE_TABLES):
        a = np.asarray(a)
        assert (a.dtype, a.shape) == (b.dtype, b.shape)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("fn", ["perlin", "turb", "marble"])
def test_noise_matches_jax_kernel_helpers(fn):
    """The port's exact-table noise against the JAX kernel's bf16 hi/lo
    table noise, at the gate of tests/test_megakernel.py:207."""
    p, q = _points()
    scale = np.random.default_rng(1).uniform(0.5, 6.0, p.shape[1]).astype(
        np.float32)
    perm, ranvec = _exact_tables()
    jp = [jnp.asarray(c[None]) for c in p]
    T = p.shape[1]
    if fn == "perlin":
        ours, ref = (tnoise.perlin_noise(*q, perm, ranvec),
                     mk._perlin_noise(*jp, T))
    elif fn == "turb":
        ours, ref = tnoise.turb(*q, perm, ranvec), mk._turb(*jp, T)
    else:
        ours = tnoise.marble(*q, torch.from_numpy(scale), perm, ranvec)
        ref = mk._marble(*jp, jnp.asarray(scale[None]), T)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref)[0], atol=5e-4)


def test_noise_matches_exact_table_noise():
    """Against the wavefront's exact-table `ops/noise.noise` and `turb`:
    the two differ only in summation order. Measured max abs difference
    6.6e-8 for perlin and 1.2e-7 for turb over these 4096 points in
    [-20, 20]^3 (against the JAX kernel's bf16 hi/lo tables: 1.9e-6); the
    gates are 2.5e-7 and 5e-7."""
    p, q = _points()
    perm, ranvec = _exact_tables()
    pts = jnp.asarray(p.T)
    np.testing.assert_allclose(tnoise.perlin_noise(*q, perm, ranvec).numpy(),
                               np.asarray(jnoise.noise(pts)), rtol=0,
                               atol=2.5e-7)
    np.testing.assert_allclose(tnoise.turb(*q, perm, ranvec).numpy(),
                               np.asarray(jnoise.turb(pts)), rtol=0,
                               atol=5e-7)


def _in_kernel(fn, *rows):
    """fn of float32 rows, run as the JAX kernel runs it: inside an
    interpret-mode Pallas kernel, where XLA fuses its multiply-adds."""
    def kern(*refs):
        refs[-1][...] = fn(*(r[...] for r in refs[:-1]))
    arrs = [jnp.asarray(r[None]) for r in rows]
    out = pl.pallas_call(kern, interpret=True, out_shape=jax.ShapeDtypeStruct(
        arrs[0].shape, jnp.float32))(*arrs)
    return np.asarray(out)[0]


def test_uv_helpers_match_jax():
    """The polynomial atan2 / asin of the sphere uv against the JAX
    kernel's, run in an interpret-mode kernel: equal to 1 ulp, with
    atan2's conventions at the axes and the -0 branch cut."""
    rng = np.random.default_rng(2)
    y = rng.uniform(-1.0, 1.0, 4096).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, 4096).astype(np.float32)
    y[:6] = [0.0, -0.0, 0.0, -0.0, 1.0, -1.0]
    x[:6] = [0.0, 0.0, -1.0, -1.0, 0.0, 0.0]
    ours = tk._atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ref = _in_kernel(mk._atan2, y, x)
    np.testing.assert_array_max_ulp(ours, ref, maxulp=1)
    ours = tk._asin(torch.from_numpy(y)).numpy()
    ref = _in_kernel(mk._asin, y)
    np.testing.assert_array_max_ulp(ours, ref, maxulp=1)


def _scenes(name):
    if name == "texture_mix":
        return texture_mix_scene(jbuilder, jst), texture_mix_scene(tbuilder,
                                                                   tst)
    return jscenes.make_scene(name, 1.0), make_scene(name, 1.0)


@functools.lru_cache(maxsize=None)
def _exact_pair(name, key):
    """One exact-spp launch on both sides: (JAX ctx, JAX image, JAX tape,
    seed, port result). The port takes JAX's seed and its plan's T."""
    js, ts = _scenes(name)
    ctx = mg.plan_tape(js, NX, NY, SPP, max_depth=DEPTH, T=256)
    img, tape, seed = mg.tape_forward(jax.random.key(key), ctx,
                                      interpret=True)
    seed = int(np.asarray(seed)[0, 0])
    res = tk.trace_mega(seed, ts, NX, NY, SPP, max_depth=DEPTH,
                        rr_depth=None, T=ctx["T"], exact=True, device="cpu")
    return ctx, np.asarray(img), np.asarray(tape), seed, res


def _assert_radiance(name, a, b, what):
    if name in NOISE_SCENES:
        np.testing.assert_allclose(a, b, rtol=0.1, atol=4e-3, err_msg=what)
        assert np.abs(a - b).mean() < 1e-4, what
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", list(KEYS))
def test_exact_spp_matches_jax_tape(name):
    same_lanes = total_lanes = 0
    for key in KEYS[name]:
        ctx, img_j, tape_j, _, res = _exact_pair(name, key)
        tape_t = res.tape.numpy()
        assert tape_t.shape == tape_j.shape
        same = (tape_t == tape_j).all(axis=1).reshape(-1)
        same_pix = same[np.asarray(ctx["inv"])].reshape(NY, NX)
        img_t = res.image.numpy() / SPP
        _assert_radiance(name, img_t[same_pix], img_j[same_pix],
                         f"key {key}")
        same_lanes += int(same_pix.sum())
        total_lanes += NX * NY
    assert same_lanes >= 0.99 * total_lanes, (
        f"{same_lanes / total_lanes:.4f} of lanes have JAX's tape")


@pytest.mark.parametrize("name", list(KEYS))
def test_jax_replay_of_port_tape(name):
    ctx, _, _, seed, res = _exact_pair(name, KEYS[name][0])
    js, _ = _scenes(name)
    replay = mg.make_replay(ctx)
    img_r = np.asarray(replay(js, jnp.asarray(res.tape.numpy()),
                              jnp.asarray([[seed]], jnp.int32)))
    _assert_radiance(name, res.image.numpy() / SPP, img_r, "replay")


def test_texture_mix_tapes_reach_every_texture():
    """The builder scene's tape holds hits on the checker sphere, the marble
    sphere, each textured rect and both media, so the tape tests above
    exercise every texture lane."""
    ctx, _, tape, _, _ = _exact_pair("texture_mix", KEYS["texture_mix"][0])
    meta = ctx["meta"]
    S, R = meta["S"], meta["R"]
    codes = set(np.unique(tape).astype(int).tolist())
    slots = meta["slot_ext"]
    assert {int(np.nonzero(slots == r)[0][0]) for r in (0, 1)} <= codes
    assert set(range(S, S + R + meta["V"])) <= codes


def _load_golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        m = re.match(r"RTWO (\d+) (\d+)", f.readline().decode())
        nx, ny = int(m.group(1)), int(m.group(2))
        data = np.frombuffer(f.read(), dtype="<f8")
    return data.reshape(ny, nx, 3)


@pytest.mark.parametrize("name,kw", [
    ("light_sample", {}),
    ("earth", {"image_path": RTWI}),
    ("earth_rect", {"image_path": RTWI})])
def test_texture_render_golden_blockwise(name, kw):
    """The blockwise gate of tests/test_golden.py through the port's
    render() (overdraw mode, two launches of 64 + 32 samples) against the
    oracle's 4096 spp renders; the earth scenes on the oracle's texels."""
    g = _load_golden(f"{name}_32x32_4096spp.bin")
    cfg = RenderConfig(nx=32, ny=32, spp=96, max_depth=50,
                       samples_per_launch=64, seed=7, loop_mode="mega",
                       device="cpu")
    stats = trender.RenderStats()
    ours = trender.render(make_scene(name, 1.0, **kw), cfg, stats=stats)
    assert ours.shape == (32, 32, 3) and ours.device.type == "cpu"
    ours = ours.numpy().astype(np.float64)

    def blk(a):
        return a.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3))

    gb, ob = blk(g), blk(ours)
    err = np.abs(ob - gb)
    tol = 0.03 + 4.0 * np.sqrt(np.maximum(gb, 0.0) / (16 * 96))
    assert (err <= tol).all(), (
        f"{(err > tol).sum()} blocks out of tolerance; "
        f"worst ratio {(err / tol).max():.2f}")
    assert stats.spp_done == 96 and stats.segments >= 32 * 32 * 96
