"""kNN kernel (``csrc/knn.cu``) and its plain PyTorch version.

Replaces ``knn_pallas`` (``dispu_tpu/ops/pallas_kernels.py``).  On an H100
the kernel is bound by its k selection rounds over each query's distance
row, which it keeps in shared memory; see the note at the top of the
source.  :func:`knn` is differentiable through :class:`KnnFunction`, which
carries ``knn_pallas_diff``'s backward rule in torch ops.
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


def knn_backward(points: torch.Tensor, queries: torch.Tensor,
                 idx: torch.Tensor, g_dist: torch.Tensor):
    """``_knn_diff_bwd`` of the JAX package: the selection held fixed, the
    distance cotangent gives ``2·g·(q − p)`` to each query and its
    negation, scatter-added, to each chosen neighbour.  Returns
    (d_points (b, n, c), d_queries (b, m, c))."""
    b, m, k = idx.shape
    c = points.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(b, m * k, c)
    neighbors = torch.gather(points, 1, flat).reshape(b, m, k, c)
    contrib = 2.0 * g_dist[..., None] * (queries[:, :, None, :] - neighbors)
    d_queries = torch.sum(contrib, dim=2)
    d_points = torch.zeros_like(points).scatter_add_(
        1, flat, -contrib.reshape(b, m * k, c))
    return d_points, d_queries


class KnnFunction(torch.autograd.Function):
    """kNN whose distances are differentiable in the points and queries:
    forward by the kernel (``use_cuda``) or by :func:`knn_torch`, backward
    by :func:`knn_backward`.  Indices and the bias carry no gradient."""

    @staticmethod
    def forward(ctx, k, points, queries, bias, use_cuda):
        run = knn_cuda if use_cuda else knn_torch
        dists, idx = run(k, points, queries, bias)
        ctx.save_for_backward(points, queries, idx)
        ctx.mark_non_differentiable(idx)
        return dists, idx

    @staticmethod
    def backward(ctx, g_dist, _g_idx):
        points, queries, idx = ctx.saved_tensors
        d_points, d_queries = knn_backward(points, queries, idx, g_dist)
        return None, d_points, d_queries, None, None


def knn(k: int, points: torch.Tensor, queries: torch.Tensor,
        bias: torch.Tensor | None = None, impl: str = "auto"):
    """k nearest ``points`` of each query, ascending, with an optional
    (b, n) column bias.  The kernel for CUDA tensors, the plain version
    for CPU tensors (see :func:`dispu_tpu_torch.kernels.use_kernel`);
    differentiable in ``points`` and ``queries``."""
    return KnnFunction.apply(k, points, queries, bias,
                             use_kernel(impl, points))
