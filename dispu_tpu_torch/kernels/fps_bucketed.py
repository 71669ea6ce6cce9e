"""Per-bucket farthest-point-sampling kernel (``csrc/fps_bucketed.cu``) and
its plain version.

Replaces ``fps_bucketed_pallas`` (``dispu_tpu/ops/pallas_kernels.py``), the
merge FPS of the bucketed (turbo) merge,
``ops.sampling.farthest_point_sample_bucketed``.  On an H100 the kernel is
bound by the latency of each bucket's serial argmax chain: one warp a
bucket, one bucket a block, every bucket of a batch of clouds in one
launch; see the note at the top of the source.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import LAUNCHES, use_kernel
from dispu_tpu_torch.kernels.fps import fps_torch

#: buckets up to this many points keep their min-distances in registers;
#: larger ones take the kernel's device-memory form
REG_MAX_NB = 2048

_P = ctypes.c_void_p
_I = ctypes.c_int


def fps_bucketed_torch(m_b: int, buckets: torch.Tensor) -> torch.Tensor:
    """Plain version: exact FPS (:func:`fps_torch`) on each of the (K, n_b,
    3) buckets → (K, m_b) int32 local indices."""
    return fps_torch(m_b, buckets)


def fps_bucketed_cuda(m_b: int, buckets: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  Same contract as :func:`fps_bucketed_torch`, for
    any bucket size."""
    from dispu_tpu_torch.kernels import _build

    if buckets.dim() != 3 or buckets.shape[-1] != 3:
        raise ValueError(f"fps_bucketed kernel takes (K, n_b, 3), got "
                         f"{tuple(buckets.shape)}")
    if (buckets.dtype != torch.float32 or not buckets.is_cuda
            or not buckets.is_contiguous()):
        raise ValueError("fps_bucketed kernel takes a contiguous float32 "
                         "CUDA tensor")
    k, nb, _ = buckets.shape
    if k < 1 or nb < 1 or m_b < 1:
        raise ValueError(f"fps_bucketed kernel needs K, n_b, m_b >= 1, got "
                         f"{(k, nb, m_b)}")
    scratch = (torch.empty((k, nb), dtype=torch.float32, device=buckets.device)
               if nb > REG_MAX_NB else None)
    out = torch.empty((k, m_b), dtype=torch.int32, device=buckets.device)
    fn = _build.load("fps_bucketed").dispu_fps_bucketed
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    with torch.cuda.device(buckets.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(buckets.data_ptr(),
                    None if scratch is None else scratch.data_ptr(),
                    out.data_ptr(), k, nb, m_b, stream)
    _build.check(status, "fps_bucketed kernel launch")
    LAUNCHES["fps_bucketed"] += 1
    return out


def fps_bucketed(m_b: int, buckets: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """(K, n_b, 3) buckets → (K, m_b) int32 local FPS indices; the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if use_kernel(impl, buckets):
        return fps_bucketed_cuda(m_b, buckets)
    return fps_bucketed_torch(m_b, buckets)
