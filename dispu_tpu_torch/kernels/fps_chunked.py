"""Cluster-wide farthest-point-sampling kernel (``csrc/fps_chunked.cu``).

Replaces ``fps_pallas_chunked`` and ``fps_pallas_chunked_batch``
(``dispu_tpu/ops/pallas_kernels.py``): exact FPS for clouds past one SM,
one cluster of 8 thread blocks per cloud, so a batch of clouds is the
grid.  Up to 147,456 points a cloud the coordinates stay in the cluster's
shared memory and the min-distances in registers; beyond, in device
memory.  It is bound by the latency of its serial argmax chain; see the
note at the top of the source.

Its plain version is :func:`dispu_tpu_torch.kernels.fps.fps_torch`, which
computes this same function (seed index 0, min-distances from 1e38,
first-occurrence argmax), so it is not repeated here.  The serving path
sends this kernel the clouds past ``fps.cu``'s limit
(``ops/sampling.py``).
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import LAUNCHES, use_kernel
from dispu_tpu_torch.kernels.fps import fps_torch

_P = ctypes.c_void_p
_I = ctypes.c_int

#: clusters of each (device index, kernel form) the card holds at once,
#: as asked of ``cudaOccupancyMaxActiveClusters`` at the first launch
MAX_CLUSTERS: dict[tuple[int, int], int] = {}


def _check_schedulable(lib, n: int, device: torch.device) -> None:
    """Raise when the card cannot hold one cluster of the kernel's form for
    ``n`` points (asked of ``cudaOccupancyMaxActiveClusters`` once)."""
    form = lib.dispu_fps_chunked_form(n)
    key = (device.index, form)
    if key not in MAX_CLUSTERS:
        from dispu_tpu_torch.kernels import _build

        count = _I(0)
        fn = lib.dispu_fps_chunked_max_clusters
        fn.argtypes = [_I, ctypes.POINTER(_I)]
        fn.restype = _I
        _build.check(fn(n, ctypes.byref(count)),
                     "fps_chunked cudaOccupancyMaxActiveClusters")
        MAX_CLUSTERS[key] = count.value
    if MAX_CLUSTERS[key] < 1:
        raise RuntimeError(
            f"fps_chunked: the card holds {MAX_CLUSTERS[key]} clusters of 8 "
            f"blocks x 1024 threads (form {form}); the kernel cannot run here")


def fps_chunked_cuda(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  Same contract as :func:`fps_torch`, any n."""
    from dispu_tpu_torch.kernels import _build

    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(
            f"fps_chunked kernel takes (b, n, 3), got {tuple(xyz.shape)}")
    if xyz.dtype != torch.float32 or not xyz.is_cuda or not xyz.is_contiguous():
        raise ValueError(
            "fps_chunked kernel takes a contiguous float32 CUDA tensor")
    b, n, _ = xyz.shape
    if b < 1 or n < 1 or npoint < 1:
        raise ValueError(f"fps_chunked kernel needs b, n, npoint >= 1, got "
                         f"{(b, n, npoint)}")
    lib = _build.load("fps_chunked")
    lib.dispu_fps_chunked_form.argtypes = [_I]
    lib.dispu_fps_chunked_form.restype = _I
    fn = lib.dispu_fps_chunked
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    scratch = None
    if lib.dispu_fps_chunked_form(n) == 0:  # past the on-chip capacity
        scratch = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        _check_schedulable(lib, n, xyz.device)
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(xyz.data_ptr(), out.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    b, n, npoint, stream)
    _build.check(status, "fps_chunked kernel launch")
    LAUNCHES["fps_chunked"] += 1
    return out


def fps_chunked(npoint: int, xyz: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """(b, n, 3) → (b, npoint) int32 FPS indices; the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if use_kernel(impl, xyz):
        return fps_chunked_cuda(npoint, xyz)
    return fps_torch(npoint, xyz)
