"""Farthest-point sampling (counterpart of ``ops/sampling.py``)."""

from __future__ import annotations

import torch

from dispu_tpu_torch.kernels import fps as _fps
from dispu_tpu_torch.kernels import fps_chunked as _fps_chunked


def fps_kernel_for(n: int) -> str:
    """The kernel that takes an ``n``-point cloud on the card: 'fps'
    (``csrc/fps.cu``, one block a cloud) up to ``FPS_MAX_N`` points,
    'fps_chunked' (``csrc/fps_chunked.cu``, one cluster a cloud) beyond."""
    return "fps" if n <= _fps.FPS_MAX_N else "fps_chunked"


def farthest_point_sample(npoint: int, xyz: torch.Tensor,
                          impl: str = "auto") -> torch.Tensor:
    """(b, n, 3) → (b, npoint) int32 indices; the first is always 0.

    impl: 'auto' (on a CUDA tensor the kernel :func:`fps_kernel_for` names,
    on a CPU tensor the plain version), 'cuda' (the kernel, or raise),
    'torch' (the plain version), or 'batch', the JAX package's name for its
    streaming merge, which routes as 'auto': every cloud of the batch
    already gets its own block or cluster.  All give the bits of the JAX
    package's ``_fps_xla``, ``fps_pallas`` and ``fps_pallas_chunked``:
    seed 0, min-distances from 1e38, first-occurrence argmax.
    """
    if impl == "batch":
        impl = "auto"
    xyz = xyz.to(torch.float32).contiguous()
    if fps_kernel_for(xyz.shape[1]) == "fps":
        return _fps.fps(npoint, xyz, impl=impl)
    return _fps_chunked.fps_chunked(npoint, xyz, impl=impl)
