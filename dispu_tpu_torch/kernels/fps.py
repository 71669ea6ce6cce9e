"""Farthest-point-sampling kernel (``csrc/fps.cu``) and its plain version.

Replaces ``fps_pallas`` and ``fps_pallas_lite``
(``dispu_tpu/ops/pallas_kernels.py``).  The TPU's lite form cuts the wide
kernel's per-round VMEM sweeps: it reads only the selected point's row,
drops the re-mask of the padding and writes one output row.  ``fps.cu``
already works so (the selected point's coordinates ride its reduction, it
has no padding and writes each index to its slot), so :func:`fps_lite`
launches the same kernel under its own count, ``LAUNCHES["fps_lite"]``;
as in the JAX package no path calls it.  On an H100 the kernel is bound
by the latency of its serial argmax chain: the cloud's coordinates and
min-distances stay in registers (one block for up to 8,192 points, a
cluster of 2, 3 or 4 blocks beyond), one reduction instruction a level
and one barrier a round; see the note at the top of the source.  It
takes clouds of up to :data:`FPS_MAX_N` points: the seed FPS and the 4×
merge of the serving path, the critic's and the ``uniform`` metric's FPS
in training.  Larger clouds (the 16× merge) go to the cluster kernel in
``fps_chunked.py``, which :func:`fps_torch` is the plain version of too.
:func:`fps` calls the custom op ``dispu_tpu_torch::fps``; :func:`fps_lite`
stays a ``ctypes`` call.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import (LAUNCHES, custom_op, forward_of,
                                     use_kernel)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: the largest cloud ``fps.cu`` takes: a cluster of 4 blocks of 1024
#: threads, 8 points a thread in registers
FPS_MAX_N = 32 * 1024


def fps_torch(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Plain version, one round at a time: seed index 0, min-distances
    start at 1e38, first-occurrence argmax, distance
    ``((x−px)² + (y−py)²) + (z−pz)²``.  When npoint exceeds the number of
    distinct points, every min-distance reaches 0 and each later round
    takes index 0, as ``_fps_xla`` does.  Returns (b, npoint) int32."""
    b, n, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    mindist = torch.full((b, n), 1e38, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    last = torch.zeros((b, 1), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        dx = x - torch.gather(x, 1, last)
        dy = y - torch.gather(y, 1, last)
        dz = z - torch.gather(z, 1, last)
        mindist = torch.minimum(mindist, (dx * dx + dy * dy) + dz * dz)
        last = torch.argmax(mindist, dim=1, keepdim=True)  # first maximum
        out[:, j:j + 1] = last
    return out.to(torch.int32)


def fps_cuda(npoint: int, xyz: torch.Tensor,
             count: str = "fps") -> torch.Tensor:
    """Launch the kernel, adding one to ``LAUNCHES[count]``.  Same contract
    as :func:`fps_torch`, for clouds of at most :data:`FPS_MAX_N`
    points."""
    from dispu_tpu_torch.kernels import _build

    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps kernel takes (b, n, 3), got {tuple(xyz.shape)}")
    b, n, _ = xyz.shape
    if n > FPS_MAX_N:
        raise ValueError(f"fps kernel takes n <= {FPS_MAX_N} points, got {n}; "
                         "larger clouds go to the fps_chunked kernel")
    if xyz.dtype != torch.float32 or not xyz.is_cuda or not xyz.is_contiguous():
        raise ValueError("fps kernel takes a contiguous float32 CUDA tensor")
    if b < 1 or n < 1 or npoint < 1:
        raise ValueError(f"fps kernel needs b, n, npoint >= 1, got "
                         f"{(b, n, npoint)}")
    fn = _build.load("fps").dispu_fps
    fn.argtypes = [_P, _P, _I, _I, _I, _P]
    fn.restype = _I
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(xyz.data_ptr(), out.data_ptr(), b, n, npoint, stream)
    _build.check(status, "fps kernel launch")
    LAUNCHES[count] += 1
    return out


def fps_fake(npoint, xyz):
    """The FPS ops' shape: (b, npoint) int32."""
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


fps_op = custom_op("fps", fps_torch, fps_cuda, fps_fake)


def fps(npoint: int, xyz: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """(b, n, 3) → (b, npoint) int32 FPS indices; the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    return forward_of(use_kernel(impl, xyz), xyz, fps_op, fps_cuda,
                      fps_torch)(npoint, xyz)


def fps_lite(npoint: int, xyz: torch.Tensor, impl: str = "auto"
             ) -> torch.Tensor:
    """``fps_pallas_lite``: the same contract and bits as :func:`fps`; the
    kernel (counted as ``fps_lite``) for a CUDA tensor, the plain version
    for a CPU tensor."""
    if use_kernel(impl, xyz):
        return fps_cuda(npoint, xyz, count="fps_lite")
    return fps_torch(npoint, xyz)
