"""The port's megakernel path against the JAX package.

On the CPU the port runs its plain PyTorch version; the JAX side runs as
its own tests run it: the Pallas kernel in interpret mode, the tape-mode
kernel (`mega_grad.tape_forward`) and the XLA replay (`make_replay`).

- Exact-spp mode is held to the JAX tape decision by decision: at least
  99% of lanes must record the same winner (sphere slot, rect or medium
  row) at every bounce, and on those lanes the radiance must match to the
  replay gate of tests/test_mega_grad.py (rtol 1e-3, atol 5e-5). Lanes
  whose tapes differ are float32 divergence: XLA:CPU's rsqrt is not
  correctly rounded, and an ulp in a direction decides grazing hits on
  random_balls' ground sphere (r = 1000, ~1e-4 of its hit point lost to
  cancellation) and, in the Cornell boxes, whether a hit point on a
  rotated box face lands on its far side and the next ray hits the face
  again at a grazing angle.
- The JAX replay fed the PORT's tape must reproduce the port's image.
- Overdraw mode agrees with the JAX kernel statistically, and render()
  passes the blockwise golden gate of tests/test_golden.py.
"""
import functools
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu.models import builder as jbuilder  # noqa: E402
from raytracingweekend_tpu.models import scene_types as jst  # noqa: E402
from raytracingweekend_tpu.models import scenes as jscenes  # noqa: E402
from raytracingweekend_tpu.ops import mega_grad as mg  # noqa: E402
from raytracingweekend_tpu.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch import render as trender  # noqa: E402
from raytracingweekend_tpu_torch.models import builder as tbuilder  # noqa: E402
from raytracingweekend_tpu_torch.models import scene_types as tst  # noqa: E402
from raytracingweekend_tpu_torch.models.probe_scenes import (  # noqa: E402
    nested_scene, shutter_scene)
from raytracingweekend_tpu_torch.models.scenes import make_scene  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402
from raytracingweekend_tpu_torch.utils.config import RenderConfig  # noqa: E402
from test_torch_kernel_card import CORNELL  # noqa: E402

# The suite runs under pytest-xdist with one worker per few cores; torch's
# default of one intra-op thread per core oversubscribes the machine there
# and slows these tests tenfold. Two threads each keep them near their
# single-process time.
torch.set_num_threads(2)

NX = NY = 16
SPP, DEPTH = 4, 5
RTOL, ATOL = 1e-3, 5e-5
# JAX keys per scene: random_balls and the Cornell variants pool four
# launches (1024 lanes), so the 99% gate is not decided by one or two
# grazing lanes of 256
KEYS = {"random_balls": (3, 4, 5, 6), "dielectric": (3,), "lens": (3, 4),
        "shutter": (3, 4), "nested": (3, 4),
        **{name: (3, 4, 5, 6) for name in CORNELL}}
TAPE_SCENES = ["random_balls", "dielectric", "lens", "shutter",
               *CORNELL, "nested"]
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _lens_scene(builder_cls, st):
    """Book-1 balls under a thin lens (aperture 0.1): a moving diffuse
    ball, fuzzy metal, glass and the ground, built by either package."""
    b = builder_cls()
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(b.constant((0.5, 0.5, 0.5))))
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian(b.constant((0.4, 0.2, 0.1))))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.3))
    b.sphere((2.0, 0.2, 2.0), 0.2, b.lambertian(b.constant((0.2, 0.7, 0.3))),
             center1=(2.0, 0.5, 2.0), time0=0.0, time1=1.0)
    b.camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, 1.0, 0.1, 10.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="lens")


def _scenes(name):
    if name == "lens":
        return (_lens_scene(jbuilder.SceneBuilder, jst),
                _lens_scene(tbuilder.SceneBuilder, tst))
    if name == "shutter":
        return (shutter_scene(jbuilder, jst),
                shutter_scene(tbuilder, tst))
    if name == "nested":
        return nested_scene(jbuilder, jst), nested_scene(tbuilder, tst)
    base, kw = CORNELL.get(name, (name, {}))
    return jscenes.make_scene(base, 1.0, **kw), make_scene(base, 1.0, **kw)


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


@pytest.mark.parametrize("name", TAPE_SCENES)
def test_exact_spp_matches_jax_tape(name):
    same_lanes = total_lanes = 0
    max_err = 0.0
    for key in KEYS[name]:
        ctx, img_j, tape_j, _, res = _exact_pair(name, key)
        tape_t = res.tape.numpy()
        assert tape_t.shape == tape_j.shape
        # both mark idle iterations -1; the tape is (n_tiles, n_iters, T)
        same = (tape_t == tape_j).all(axis=1).reshape(-1)
        inv = np.asarray(ctx["inv"])
        same_pix = same[inv].reshape(NY, NX)
        img_t = res.image.numpy() / SPP
        a, b = img_t[same_pix], img_j[same_pix]
        max_err = max(max_err, float(np.abs(a - b).max()))
        assert np.allclose(a, b, rtol=RTOL, atol=ATOL), (
            f"key {key}: max abs err {np.abs(a - b).max():.3g}")
        same_lanes += int(same_pix.sum())
        total_lanes += NX * NY
    frac = same_lanes / total_lanes
    assert frac >= 0.99, (f"{frac:.4f} of lanes have JAX's tape "
                          f"(max abs err on them {max_err:.3g})")


@pytest.mark.parametrize("name", TAPE_SCENES)
def test_jax_replay_of_port_tape(name):
    """ROADMAP level 3: the JAX replay, fed the port's own winner tape,
    reproduces the port's image to the replay gate."""
    ctx, _, _, seed, res = _exact_pair(name, KEYS[name][0])
    js, _ = _scenes(name)
    replay = mg.make_replay(ctx)
    img_r = np.asarray(replay(js, jnp.asarray(res.tape.numpy()),
                              jnp.asarray([[seed]], jnp.int32)))
    img_t = res.image.numpy() / SPP
    err = np.abs(img_t - img_r)
    assert np.allclose(img_t, img_r, rtol=RTOL, atol=ATOL), (
        f"max abs err {err.max():.3g}")
    # exact mode traces exactly spp samples per valid lane
    segs = float(res.segments)
    assert segs >= NX * NY * SPP and float(res.lane_iters) == segs


def test_overdraw_matches_jax_statistically():
    nx = ny = 16
    spp, depth = 8, 8
    js, ts = jscenes.make_scene("random_balls", 1.0), make_scene("random_balls",
                                                             1.0)
    T = mk.make_plan(js, nx, ny, spp, max_depth=depth, T=256)[2]
    img_j, segs_j, iters_j, _ = mk.trace_mega(
        jax.random.key(11), js, nx, ny, spp, max_depth=depth, T=256,
        interpret=True, return_stats=True)
    res = tk.trace_mega(2024, ts, nx, ny, spp, max_depth=depth, T=T,
                        device="cpu")
    mean_j = float(np.asarray(img_j).mean()) / spp
    mean_t = float(res.image.mean()) / spp
    assert abs(mean_t - mean_j) <= 0.05 * mean_j, (mean_t, mean_j)
    util_j = float(segs_j) / float(iters_j)
    util_t = float(res.segments) / float(res.lane_iters)
    assert abs(util_t - util_j) <= 0.10 * util_j, (util_t, util_j)
    # overdraw: every valid lane traces at least spp samples
    assert float(res.segments) >= nx * ny * spp


def _load_golden(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        m = re.match(r"RTWO (\d+) (\d+)", f.readline().decode())
        nx, ny = int(m.group(1)), int(m.group(2))
        data = np.frombuffer(f.read(), dtype="<f8")
    return data.reshape(ny, nx, 3)


@pytest.mark.parametrize("name,golden", [
    ("random_balls", "random_balls_32x32_2048spp.bin"),
    ("dielectric", "dielectric_32x32_4096spp.bin")])
def test_render_golden_blockwise(name, golden):
    """The blockwise gate of tests/test_golden.py through the port's
    render() (overdraw mode, two launches of 64 + 32 samples)."""
    g = _load_golden(golden)
    cfg = RenderConfig(nx=32, ny=32, spp=96, max_depth=50,
                       samples_per_launch=64, seed=7, loop_mode="mega",
                       device="cpu")
    stats = trender.RenderStats()
    ours = trender.render(make_scene(name, 1.0), cfg, stats=stats)
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
    assert stats.pixel_variance > 0.0


def test_launch_seeds_are_deterministic_and_distinct():
    seeds = [trender.launch_seed(7, k) for k in range(8)]
    assert seeds == [trender.launch_seed(7, k) for k in range(8)]
    assert len(set(seeds)) == 8
    assert all(0 <= s < 2 ** 31 - 1 for s in seeds)
    assert trender.launch_seed(8, 0) != seeds[0]


LAUNCHES_PAST_2_16 = ((1 << 16), (1 << 16) + 1, (1 << 20) + 3, 2 ** 31 - 1,
                      2 ** 32 - 1)


@pytest.mark.parametrize("seed,launches", [
    pytest.param(s, range(6), id=str(s))
    for s in (0, 7, 20240601, -1, -(2 ** 31), 2 ** 31 - 1, 2 ** 32,
              2 ** 32 + 5)
] + [
    pytest.param(s, LAUNCHES_PAST_2_16, id=f"{s}-past-2^16")
    for s in (0, 20240601, 2 ** 32 + 5)
])
def test_launch_seed_is_jax_per_launch_seed(seed, launches):
    """Launch k of a render seeded `seed` gets the kernel seed JAX's render
    passes it: randint(fold_in(key(seed), k), (1, 1), 0, 2**31 - 1). The
    seeds cover the key's masking (negative, the int32 maximum, past
    2^32), and launch indices past 2^16."""
    for k in launches:
        jk = jax.random.fold_in(jax.random.key(seed), k)
        want = int(np.asarray(jax.random.randint(
            jk, (1, 1), 0, np.int32(2 ** 31 - 1), dtype=jnp.int32))[0, 0])
        assert trender.launch_seed(seed, k) == want


def test_cli_writes_ppm_as_jax_does(tmp_path):
    """`--out x.ppm` writes a P3 PPM byte for byte as the JAX package's
    write_ppm writes the same canvas (and a .png path still gets a PNG)."""
    from raytracingweekend_tpu.utils import image as jimage

    argv = ["--scene", "cornell_box", "--nx", "6", "--ny", "5", "--spp", "2",
            "--max-depth", "3", "--device", "cpu", "--mode", "mega"]
    out = tmp_path / "c.ppm"
    trender.main(argv + ["--out", str(out)])
    cfg = RenderConfig(nx=6, ny=5, spp=2, samples_per_launch=2, max_depth=3,
                       seed=0, loop_mode="mega", device="cpu")
    canvas = trender.render(make_scene("cornell_box", 6 / 5), cfg).numpy()
    ref = tmp_path / "ref.ppm"
    jimage.write_ppm(jimage.postprocess(canvas), str(ref))
    assert out.read_bytes() == ref.read_bytes()
    assert out.read_bytes().startswith(b"P3\n6 5\n255\n")
    png = tmp_path / "c.png"
    trender.main(argv + ["--out", str(png)])
    assert png.read_bytes().startswith(b"\x89PNG")


@pytest.mark.parametrize("scene_args,scene", [
    (["--scene", "dielectric"], "dielectric"),
    ([], "cornell_box")])   # the default is the reference's scene
def test_cli_writes_png(tmp_path, capsys, scene_args, scene):
    out = tmp_path / "tiny.png"
    trender.main([*scene_args, "--nx", "8", "--ny", "6",
                  "--spp", "2", "--samples-per-launch", "1",
                  "--max-depth", "3", "--device", "cpu", "--stats",
                  "--out", str(out)])
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IHDR" in data
    assert f"({scene}, 8x6, 2 spp)" in capsys.readouterr().out


def test_cuda_requests_raise_without_a_card():
    """No fallback: a CUDA request on a machine without a card raises (and
    the entry points ask for the card unless told otherwise), and asking
    for the kernel on a CPU tensor raises."""
    scene = make_scene("dielectric", 1.0)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tk.trace_mega(1, scene, 8, 8, 1, device="cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            tk.trace_mega(1, scene, 8, 8, 1)
        with pytest.raises((RuntimeError, AssertionError)):
            trender.render(scene, RenderConfig(nx=8, ny=8, spp=1,
                                               loop_mode="mega",
                                               device="cuda"))
        with pytest.raises((RuntimeError, AssertionError)):
            trender.render(scene, RenderConfig(nx=8, ny=8, spp=1,
                                               device="cuda"))
    _, plan = tk.make_plan(scene, 8, 8, 1)
    args, _ = tk.device_inputs(scene, plan, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.mega_kernel(*args, 1, plan)
