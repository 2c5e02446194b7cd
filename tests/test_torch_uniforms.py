"""The port's device helpers against the JAX megakernel's.

`_uniforms` (the lowbias32 counter-hash RNG) must be bitwise equal to
`raytracingweekend_tpu.ops.megakernel._uniforms`: the port keeps the same
(seed, tile, iteration, salt, row, lane) stream keys. `_cossin2pi` and
`_onb` are held to the JAX helpers as the JAX kernel runs them, under jit,
where XLA contracts multiply-adds into FMAs (the port writes those FMAs
out)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu.ops import megakernel as mk  # noqa: E402
from raytracingweekend_tpu_torch.ops import megakernel as tk  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 987654321, 2 ** 31 - 2,
                                  2 ** 31 - 1, -(2 ** 31)])
def test_uniforms_bitwise(seed):
    for tile in (0, 7, 3749):
        for it in (-1, 0, 5, 2 ** 20):
            for salt in (1, 2, 3):
                a = np.asarray(mk._uniforms(
                    8, 256, jnp.int32(seed), jnp.int32(tile), jnp.int32(it),
                    salt, bitcast=jax.lax.bitcast_convert_type))
                b = tk._uniforms(8, 256, seed, tile, it, salt).numpy()
                assert a.dtype == b.dtype == np.float32
                assert a.tobytes() == b.tobytes(), (seed, tile, it, salt)
                assert (b >= 0.0).all() and (b < 1.0).all()


def test_uniform_rows_follow_tile_and_lane_layout():
    """The plain version hashes many tiles at once: each (tile, lane) of a
    broadcast key equals the scalar-tile stream."""
    seed, it, salt = 12345, 3, 2
    tiles = torch.tensor([[0], [5], [11]], dtype=torch.int64)
    lanes = torch.arange(64, dtype=torch.int64)
    base = tk._stream_base(seed, tiles, it, salt, lanes)
    for r in range(7):
        got = tk._uniform_row(base, r)
        for k, t in enumerate((0, 5, 11)):
            want = tk._uniforms(7, 64, seed, t, it, salt)[r]
            assert torch.equal(got[k], want)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_cossin2pi_matches_jit():
    u = np.random.default_rng(0).random(1 << 18).astype(np.float32)
    ca, sa = (np.asarray(x) for x in jax.jit(mk._cossin2pi)(jnp.asarray(u)))
    cb, sb = (x.numpy() for x in tk._cossin2pi(torch.from_numpy(u)))
    # measured: bitwise equal; the gate allows the 1 ulp a double-rounded
    # FMA emulation could cost
    assert _ulps(ca, cb).max() <= 1 and _ulps(sa, sb).max() <= 1
    assert np.abs(np.hypot(cb, sb) - 1.0).max() < 2e-6


def test_onb_matches_jit():
    """Bitwise where the two backends' rsqrt agree; within 2 ulp of 1.0
    elsewhere: XLA:CPU's and torch's rsqrt are not correctly rounded and
    differ by up to 2 ulp, and u and v inherit that through 1/|v|."""
    w = np.random.default_rng(1).normal(size=(3, 1 << 18)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0)
    wx, wy, wz = w
    ra = [np.asarray(x) for x in jax.jit(mk._onb)(*map(jnp.asarray, w))]
    rb = [x.numpy() for x in tk._onb(*map(torch.from_numpy, w))]
    # the rsqrt argument both sides compute (FMA form, one rounding each)
    bigx = np.abs(wx) > 0.9
    vx = np.where(bigx, -wz, 0.0).astype(np.float32)
    vy = np.where(bigx, 0.0, wz).astype(np.float32)
    vz = np.where(bigx, wx, -wy).astype(np.float32)
    t = torch.from_numpy
    s = (tk._fma(t(vz), t(vz), tk._fma(t(vx), t(vx), t(vy) * t(vy)))
         + 1e-30)
    same_rsqrt = (np.asarray(jax.lax.rsqrt(jnp.asarray(s.numpy())))
                  == torch.rsqrt(s).numpy())
    assert same_rsqrt.mean() > 0.5
    for a, b in zip(ra, rb):
        assert _ulps(a, b)[same_rsqrt].max() == 0
        assert np.abs(a - b).max() <= 2.0 ** -22
