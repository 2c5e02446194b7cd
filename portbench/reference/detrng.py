"""Deterministic host-side RNG for scene construction and noise tables.

The reference builds the random-balls scene and the Perlin tables with
default-seeded std::minstd_rand engines consumed through
std::uniform_real_distribution<double> (Scene/scene.h:103-104,
noise.h:166-213), so both are bit-reproducible run to run.
For golden parity this replicates the libstdc++ double stream of the
oracle build (tools/reference_oracle): generate_canonical for a 53-bit
double over minstd_rand (range R = 2^31 - 2) takes TWO engine steps:

    x1, x2 = engine(), engine()          # x -> 48271*x mod (2^31 - 1)
    u = ((x1 - 1) + (x2 - 1) * R) / R^2  # first draw is the low-order part
"""
from __future__ import annotations

import numpy as np

MINSTD_A = 48271
MINSTD_M = 2147483647  # 2**31 - 1
_R = float(MINSTD_M - 1)  # engine range: max - min + 1 = 2^31 - 2


class MinStd:
    """std::minstd_rand + libstdc++ uniform_real_distribution<double>."""

    def __init__(self, seed: int = 1):
        self.x = seed

    def _step(self) -> int:
        self.x = (self.x * MINSTD_A) % MINSTD_M
        return self.x

    def uniform(self) -> float:
        x1 = self._step()
        x2 = self._step()
        return ((x1 - 1) + (x2 - 1) * _R) / (_R * _R)


def minstd_stream(n: int, seed: int = 1) -> np.ndarray:
    """First n uniform doubles of a default-seeded engine (libstdc++
    semantics, two engine steps per double)."""
    eng = MinStd(seed)
    return np.array([eng.uniform() for _ in range(n)], dtype=np.float64)
