"""Per-bucket farthest-point-sampling kernel (``csrc/fps_bucketed.cu``) and
its plain version.

Replaces ``fps_bucketed_pallas`` (``dispu_tpu/ops/pallas_kernels.py``), the
merge FPS of the bucketed (turbo) merge,
``ops.sampling.farthest_point_sample_bucketed``.  On an H100 the kernel is
bound by the latency of each bucket's serial argmax chain.  A bucket is
one cloud of ``fps.cu``'s round (``csrc/fps_common.cuh``: the points in
registers, ``redux.sync`` a level, one barrier a round), every bucket of a
batch of clouds in one launch; the kernel picks the form for a bucket size
(:func:`form_for` asks it): a block of 2 to 32 warps with three points a
thread in registers (six up to 6,144 points), the coordinates in shared
memory up to 18,432, both in device memory beyond, with a scratch of
min-distances that the wrapper allocates.  See the note at the top of the
source.  :func:`fps_bucketed` calls the custom op
``dispu_tpu_torch::fps_bucketed``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dispu_tpu_torch.kernels import (LAUNCHES, custom_op, forward_of,
                                     use_kernel)
from dispu_tpu_torch.kernels.fps import fps_fake, fps_torch
from dispu_tpu_torch.kernels.fps_chunked import STORAGES, Form

_P = ctypes.c_void_p
_I = ctypes.c_int


def fps_bucketed_torch(m_b: int, buckets: torch.Tensor) -> torch.Tensor:
    """Plain version: exact FPS (:func:`fps_torch`) on each of the (K, n_b,
    3) buckets → (K, m_b) int32 local indices."""
    return fps_torch(m_b, buckets)


@functools.cache
def _lib():
    """The kernel's library, built, loaded and bound once."""
    from dispu_tpu_torch.kernels import _build

    lib = _build.load("fps_bucketed")
    lib.dispu_fps_bucketed_form.argtypes = [_I, ctypes.POINTER(_I)]
    lib.dispu_fps_bucketed.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    for fn in (lib.dispu_fps_bucketed_form, lib.dispu_fps_bucketed):
        fn.restype = _I
    return lib


@functools.cache
def form_for(nb: int) -> Form:
    """The form the kernel takes for buckets of ``nb`` points (builds
    it)."""
    from dispu_tpu_torch.kernels import _build

    shape = (_I * 4)()
    _build.check(_lib().dispu_fps_bucketed_form(nb, shape),
                 f"fps_bucketed form for n_b = {nb}")
    cluster, threads, points, storage = shape
    return Form(cluster, threads, points, STORAGES[storage])


def forms_from(nb: int) -> list[Form]:
    """The forms the kernel takes for buckets of ``nb`` points and more, in
    order: each on-chip form up to its capacity, then the device form."""
    forms = [form_for(nb)]
    while forms[-1].storage != "device":
        forms.append(form_for(forms[-1].capacity + 1))
    return forms


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
    form = form_for(nb)
    scratch = (torch.empty((k, nb), dtype=torch.float32, device=buckets.device)
               if form.storage == "device" else None)
    out = torch.empty((k, m_b), dtype=torch.int32, device=buckets.device)
    with torch.cuda.device(buckets.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().dispu_fps_bucketed(
            buckets.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), k, nb, m_b, stream)
    _build.check(status, f"fps_bucketed kernel launch ({form})")
    LAUNCHES["fps_bucketed"] += 1
    return out


fps_bucketed_op = custom_op("fps_bucketed", fps_bucketed_torch,
                            fps_bucketed_cuda, fps_fake)


def fps_bucketed(m_b: int, buckets: torch.Tensor,
                 impl: str = "auto") -> torch.Tensor:
    """(K, n_b, 3) buckets → (K, m_b) int32 local FPS indices; the kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    return forward_of(use_kernel(impl, buckets), buckets, fps_bucketed_op,
                      fps_bucketed_cuda, fps_bucketed_torch)(m_b, buckets)
