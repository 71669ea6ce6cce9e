"""The GAN step's history pool of generated clouds (counterpart of
``utils/visu.py``'s ``PointPool``; the renders are not ported)."""

from __future__ import annotations

import numpy as np


class PointPool:
    """History buffer of generated point clouds (the CycleGAN image pool).

    While the pool fills, ``query`` stores its input and returns it; once
    full, with probability 0.5 it swaps the input for a stored batch
    chosen at random and returns that one, else it returns the input.  The
    draws come from a ``numpy.random.RandomState`` (seeded by the caller),
    so a seed gives the JAX package's sequence."""

    def __init__(self, pool_size: int = 20, rng=None):
        self.pool_size = pool_size
        self.points: list = []
        self.rng = rng if rng is not None else np.random.RandomState()

    def query(self, point: np.ndarray) -> np.ndarray:
        if self.pool_size == 0:
            return point
        if len(self.points) < self.pool_size:
            self.points.append(np.asarray(point).copy())
            return point
        if self.rng.rand() > 0.5:
            random_id = self.rng.randint(0, self.pool_size)
            tmp = self.points[random_id].copy()
            self.points[random_id] = np.asarray(point).copy()
            return tmp
        return point
