"""kNN kernel (``csrc/knn.cu``) and its plain PyTorch version.

Replaces ``knn_pallas`` (``dispu_tpu/ops/pallas_kernels.py``), forward
only: the autograd rule comes with the training slice.  On an H100 the
kernel is bound by its k selection rounds over each query's distance row,
which it keeps in shared memory; see the note at the top of the source.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import LAUNCHES, use_kernel
from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

#: one query's distance row plus the query, in floats, must fit one
#: block's shared memory (232,448 bytes on Hopper)
MAX_ROW_FLOATS = 232448 // 4

_P = ctypes.c_void_p
_I = ctypes.c_int


def knn_torch(k: int, points: torch.Tensor, queries: torch.Tensor,
              bias: torch.Tensor | None = None):
    """Plain version: the full distance matrix, then a stable sort.

    ``torch.topk`` does not pin the order of ties; the stable sort gives
    the lexicographic (distance, index) order of ``lax.top_k`` and of the
    kernels.  Returns ((b, m, k) f32 ascending, (b, m, k) int32).
    """
    d = pairwise_sq_dist(queries, points)
    if bias is not None:
        d = d + bias[..., None, :]
    d, idx = torch.sort(d, dim=-1, stable=True)
    return d[..., :k].contiguous(), idx[..., :k].to(torch.int32).contiguous()


def _check(k, points, queries, bias):
    if points.dim() != 3 or queries.dim() != 3:
        raise ValueError("knn kernel takes (b, n, c) points and (b, m, c) "
                         "queries")
    b, n, c = points.shape
    if queries.shape[0] != b or queries.shape[2] != c:
        raise ValueError(f"queries {tuple(queries.shape)} do not match "
                         f"points {tuple(points.shape)}")
    tensors = [points, queries] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("knn kernel takes contiguous float32 CUDA "
                             "tensors")
        if t.device != points.device:
            raise ValueError("knn kernel inputs lie on different devices")
    if bias is not None and tuple(bias.shape) != (b, n):
        raise ValueError(f"bias must be (b, n) = {(b, n)}")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, n={n}]")
    if n + c > MAX_ROW_FLOATS:
        raise ValueError(
            f"knn kernel holds a query's n + c = {n + c} floats in shared "
            f"memory; the limit is {MAX_ROW_FLOATS}"
        )


def knn_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
             bias: torch.Tensor | None = None):
    """Launch the kernel.  Same contract as :func:`knn_torch`."""
    from dispu_tpu_torch.kernels import _build

    _check(k, points, queries, bias)
    b, n, c = points.shape
    m = queries.shape[1]
    if bias is None:
        bias = torch.zeros((b, n), dtype=torch.float32, device=points.device)
    dists = torch.empty((b, m, k), dtype=torch.float32, device=points.device)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=points.device)
    fn = _build.load("knn").dispu_knn
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(points.data_ptr(), queries.data_ptr(), bias.data_ptr(),
                    dists.data_ptr(), idx.data_ptr(), b, n, m, c, k, stream)
    _build.check(status, "knn kernel launch")
    LAUNCHES["knn"] += 1
    return dists, idx


def knn(k: int, points: torch.Tensor, queries: torch.Tensor,
        bias: torch.Tensor | None = None, impl: str = "auto"):
    """k nearest ``points`` of each query, ascending, with an optional
    (b, n) column bias.  The kernel for CUDA tensors, the plain version
    for CPU tensors (see :func:`dispu_tpu_torch.kernels.use_kernel`)."""
    if use_kernel(impl, points):
        return knn_cuda(k, points, queries, bias)
    return knn_torch(k, points, queries, bias)
