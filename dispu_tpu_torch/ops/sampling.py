"""Farthest-point sampling (counterpart of ``ops/sampling.py``)."""

from __future__ import annotations

import torch

from dispu_tpu_torch.kernels import fps as _fps


def farthest_point_sample(npoint: int, xyz: torch.Tensor,
                          impl: str = "auto") -> torch.Tensor:
    """(b, n, 3) → (b, npoint) int32 indices; the first is always 0.

    impl: 'auto' (the FPS kernel for a CUDA tensor, its plain version for a
    CPU tensor), 'cuda' (the kernel, or raise) or 'torch' (the plain
    version).  Both give the bits of the JAX package's ``_fps_xla`` and
    ``fps_pallas``: seed 0, min-distances from 1e38, first-occurrence
    argmax.
    """
    return _fps.fps(npoint, xyz.to(torch.float32).contiguous(), impl=impl)
