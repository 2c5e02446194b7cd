"""The port's threefry keys and uniforms (utils/prng.py) against
jax.random: key, fold_in, split and uniform bit for bit, for several seeds
and shapes, so the port's wavefront draws JAX's random numbers."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracingweekend_tpu.ops import sampling as jsampling  # noqa: E402
from raytracingweekend_tpu_torch.ops import sampling as tsampling  # noqa: E402
from raytracingweekend_tpu_torch.utils import prng  # noqa: E402

SEEDS = (0, 5, 7, 123456, 2 ** 31 - 1)


def _words(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bitwise(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    assert _words(jk) == tk
    for data in (0, 1, 7, 1000003, 2 ** 31 - 1):
        assert _words(jax.random.fold_in(jk, data)) == prng.fold_in(tk, data)
    for n in (2, 3, 4, 5):
        js = np.asarray(jax.random.key_data(jax.random.split(jk, n)))
        assert [tuple(int(w) for w in row) for row in js] == prng.split(tk, n)
    # a chain of derivations, as the integrators make them
    jc, tc = jk, tk
    for step in range(6):
        jc = jax.random.split(jax.random.fold_in(jc, step), 3)[step % 3]
        tc = prng.split(prng.fold_in(tc, step), 3)[step % 3]
        assert _words(jc) == tc


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (1000,), (257, 3), (4, 5, 3)])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 2.0 * math.pi),
                                   (-1.0, 1.0)])
def test_uniform_bitwise(seed, shape, lo, hi):
    k = jax.random.fold_in(jax.random.key(seed), 11)
    j = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi))
    t = prng.uniform(_words(k), shape, lo, hi, device="cpu").numpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    assert j.tobytes() == t.tobytes()


def test_lanes_do_not_depend_on_the_batch_size():
    """Partitionable threefry: element i's bits depend on i alone."""
    k = prng.key(3)
    a = prng.uniform(k, (64,), device="cpu")
    b = prng.uniform(k, (4096,), device="cpu")
    assert torch.equal(a, b[:64])


def test_random_int_bitwise():
    k = jax.random.key(9)
    j = np.asarray(jsampling.random_int(k, (5000,), 0, 2))
    t = tsampling.random_int(_words(k), (5000,), 0, 2, device="cpu").numpy()
    assert np.array_equal(j, t) and set(np.unique(t)) == {0, 1, 2}
