"""Cluster-wide farthest-point-sampling kernel (``csrc/fps_chunked.cu``).

Replaces ``fps_pallas_chunked`` and ``fps_pallas_chunked_batch``
(``dispu_tpu/ops/pallas_kernels.py``): exact FPS for clouds past one SM,
one thread block cluster per cloud, so a batch of clouds is the grid.  It
takes ``fps.cu``'s round (``csrc/fps_common.cuh``: ``redux.sync`` a
level, each warp's winner pushed into every block, one cluster barrier a
round) and is bound by the latency of that serial argmax chain.  The
kernel picks the form for an n-point cloud (:func:`form_for` asks it):
the coordinates and min-distances in registers up to 98,304 points (the
16× merge of a 2048-point cloud), the coordinates in the cluster's shared
memory up to 147,456, both in device memory beyond, with a scratch of
min-distances that the wrapper allocates.

Its plain version is :func:`dispu_tpu_torch.kernels.fps.fps_torch`, which
computes this same function (seed index 0, min-distances from 1e38,
first-occurrence argmax), so it is not repeated here.  The serving path
sends this kernel the clouds past ``fps.cu``'s limit
(``ops/sampling.py``), through the custom op ``dispu_tpu_torch::fps_chunked``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dispu_tpu_torch.kernels import (LAUNCHES, custom_op, forward_of,
                                     use_kernel)
from dispu_tpu_torch.kernels.fps import fps_fake, fps_torch

_P = ctypes.c_void_p
_I = ctypes.c_int

#: where a form keeps its points, in the order of ``fps_round::Storage``
STORAGES = ("registers", "shared", "device")


class Form(NamedTuple):
    """A cluster of ``cluster`` blocks of ``threads`` threads, each thread
    holding ``points`` points (0 for the device form) where ``storage``
    says."""

    cluster: int
    threads: int
    points: int
    storage: str

    @property
    def capacity(self) -> int:
        """The largest cloud the form holds (0 for the device form, which
        holds any)."""
        return self.cluster * self.threads * self.points

    def __str__(self) -> str:
        per = f" x {self.points} points" if self.points else ""
        return (f"{self.cluster} blocks x {self.threads} threads{per} "
                f"({self.storage})")


#: clusters of each (device index, form) the card holds at once, as asked
#: of ``cudaOccupancyMaxActiveClusters`` at the form's first launch
MAX_CLUSTERS: dict[tuple[int, Form], int] = {}


def _lib():
    from dispu_tpu_torch.kernels import _build

    lib = _build.load("fps_chunked")
    lib.dispu_fps_chunked_form.argtypes = [_I, ctypes.POINTER(_I)]
    lib.dispu_fps_chunked_max_clusters.argtypes = [_I, ctypes.POINTER(_I)]
    lib.dispu_fps_chunked.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    for fn in (lib.dispu_fps_chunked_form, lib.dispu_fps_chunked_max_clusters,
               lib.dispu_fps_chunked):
        fn.restype = _I
    return lib


def form_for(n: int) -> Form:
    """The form the kernel takes for an ``n``-point cloud (builds it)."""
    from dispu_tpu_torch.kernels import _build

    shape = (_I * 4)()
    _build.check(_lib().dispu_fps_chunked_form(n, shape),
                 f"fps_chunked form for n = {n}")
    cluster, threads, points, storage = shape
    return Form(cluster, threads, points, STORAGES[storage])


def forms_from(n: int) -> list[Form]:
    """The forms the kernel takes for clouds of ``n`` points and more, in
    order: each on-chip form up to its capacity, then the device form."""
    forms = [form_for(n)]
    while forms[-1].storage != "device":
        forms.append(form_for(forms[-1].capacity + 1))
    return forms


def _check_schedulable(lib, form: Form, n: int, device: torch.device) -> None:
    """Raise when the card cannot hold one cluster of ``form``, the form for
    ``n`` points (asked of ``cudaOccupancyMaxActiveClusters`` once a device
    and form)."""
    from dispu_tpu_torch.kernels import _build

    key = (device.index, form)
    if key not in MAX_CLUSTERS:
        count = _I(0)
        status = lib.dispu_fps_chunked_max_clusters(n, ctypes.byref(count))
        _build.check(status,
                     f"fps_chunked cudaOccupancyMaxActiveClusters ({form})")
        MAX_CLUSTERS[key] = count.value
    if MAX_CLUSTERS[key] < 1:
        raise RuntimeError(
            f"fps_chunked: the card holds {MAX_CLUSTERS[key]} clusters of "
            f"{form}; the kernel cannot run here")


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
    lib = _lib()
    form = form_for(n)
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    scratch = None
    if form.storage == "device":
        scratch = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        _check_schedulable(lib, form, n, xyz.device)
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.dispu_fps_chunked(
            xyz.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, n, npoint,
            stream)
    _build.check(status, f"fps_chunked kernel launch ({form})")
    LAUNCHES["fps_chunked"] += 1
    return out


fps_chunked_op = custom_op("fps_chunked", fps_torch, fps_chunked_cuda,
                           fps_fake)


def fps_chunked(npoint: int, xyz: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """(b, n, 3) → (b, npoint) int32 FPS indices; the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    return forward_of(use_kernel(impl, xyz), xyz, fps_chunked_op,
                      fps_chunked_cuda, fps_torch)(npoint, xyz)
