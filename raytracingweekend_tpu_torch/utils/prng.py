"""Threefry-2x32 keys and uniforms, bit for bit those of `jax.random`.

The wavefront integrator draws its random numbers from `jax.random` keys:
`key`, `fold_in`, `split` and `uniform` with the threefry-2x32 generator in
its partitionable form (`jax_threefry_partitionable=True`, JAX's default),
where each element's bits depend only on the key and the element's flat
index. This module computes the same numbers, so the port's wavefront and
the JAX package's draw the same uniforms lane for lane from the same seed.

A key is a pair of Python ints (two uint32 words): key derivation is
scalar host work. `uniform` and `random_bits` hash one counter per element
on a device, in int64 tensors masked to 32 bits (torch has no full uint32
arithmetic).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: int, k2: int, x1, x2):
    """The threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)
    under the key (k1, k2). x1 and x2 are Python ints or int64 tensors
    holding uint32 values; returns the pair of hashed words alike."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def key(seed: int) -> Key:
    """`jax.random.key(seed)` for an int32 seed: the words (0, seed)."""
    return (0, int(seed) & MASK)


def fold_in(k: Key, data: int) -> Key:
    """`jax.random.fold_in(k, data)`: the hash of the counter (0, data)."""
    return threefry2x32(k[0], k[1], 0, int(data) & MASK)


def split(k: Key, num: int = 2) -> list:
    """`jax.random.split(k, num)`: key i is the hash of the counter (0, i)."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def random_bits(k: Key, shape, device) -> torch.Tensor:
    """32 random bits per element (int64 tensor of `shape`): the two words
    of the hash of the element's flat index, xor-ed."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k[0], k[1], idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(shape)


def uniform(k: Key, shape=(), minval: float = 0.0, maxval: float = 1.0,
            device="cuda") -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)`: 23 random
    mantissa bits under the exponent of 1.0, minus 1, scaled into
    [minval, maxval) and clamped below at minval, all in float32."""
    shape = tuple(shape)
    bits = random_bits(k, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = fbits.view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    if span != 1.0 or lo != 0.0:
        u = u * span + float(lo)
    return torch.clamp_min(u, float(lo))
