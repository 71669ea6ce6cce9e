"""Fused kNN + neighbourhood gather kernel (``csrc/knn_group.cu``) and its
plain PyTorch version.

Replaces ``knn_group_pallas`` (``dispu_tpu/ops/pallas_kernels.py``),
forward only: the backbone's fused edge gather (``nn.edgeconv.edge_parts``,
``drop_first`` with the duplicate bias, features only) and the refiner's
fused grouping (``ops.grouping.grouping``, with xyz) of the turbo serving
path.  On an H100 the kernel is bound by the bytes of its gathered rows;
see the note at the top of the source.  Its (dists, idx) are bit-equal to
the kNN kernel's on the same inputs.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import LAUNCHES, use_kernel
from dispu_tpu_torch.kernels.knn import MAX_ROW_FLOATS, knn_torch

#: the widest feature row the JAX package's kernel takes
MAX_C = 384

_P = ctypes.c_void_p
_I = ctypes.c_int


def rows_at(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (b, n, c) ``table`` at (b, m, k) indices → (b, m, k, c)."""
    b, m, k = idx.shape
    c = table.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(b, m * k, c)
    return torch.gather(table, 1, flat).reshape(b, m, k, c)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 → bf16 (round to nearest even) → f32: the turbo gathers' value
    (``_bf16_terms``' leading term, ``group_point(impl='onehot')``)."""
    return x.to(torch.bfloat16).to(torch.float32)


def knn_group_torch(k: int, points: torch.Tensor, queries: torch.Tensor,
                    feats: torch.Tensor,
                    column_bias: torch.Tensor | None = None,
                    exact: bool = True, with_xyz: bool = True,
                    drop_first: bool = False):
    """Plain version: :func:`knn_torch` with k (or k + 1 with
    ``drop_first``, the first column then dropped), then index gathers of
    ``feats`` (bf16-rounded unless ``exact``) and, with ``with_xyz``, of
    ``points``.  Returns (dists (b, m, k), idx (b, m, k) int32,
    grouped_xyz (b, m, k, 3) or None, grouped_feat (b, m, k, c))."""
    d, idx = knn_torch(k + int(drop_first), points, queries, column_bias)
    if drop_first:
        d, idx = d[..., 1:].contiguous(), idx[..., 1:].contiguous()
    gfeat = rows_at(feats, idx)
    if not exact:
        gfeat = bf16_round(gfeat)
    return d, idx, rows_at(points, idx) if with_xyz else None, gfeat


def _check(k, points, queries, feats, bias, with_xyz, drop_first):
    if points.dim() != 3 or queries.dim() != 3 or feats.dim() != 3:
        raise ValueError("knn_group kernel takes (b, n, c) points and feats "
                         "and (b, m, c) queries")
    b, n, c = points.shape
    if queries.shape[0] != b or queries.shape[2] != c:
        raise ValueError(f"queries {tuple(queries.shape)} do not match "
                         f"points {tuple(points.shape)}")
    if tuple(feats.shape[:2]) != (b, n):
        raise ValueError(f"feats {tuple(feats.shape)} do not match points "
                         f"{tuple(points.shape)}")
    tensors = [points, queries, feats] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("knn_group kernel takes contiguous float32 CUDA "
                             "tensors")
        if t.device != points.device:
            raise ValueError("knn_group kernel inputs lie on different "
                             "devices")
    if bias is not None and tuple(bias.shape) != (b, n):
        raise ValueError(f"column_bias must be (b, n) = {(b, n)}")
    if feats.shape[2] > MAX_C:
        raise ValueError(f"knn_group kernel takes c <= {MAX_C} features, got "
                         f"{feats.shape[2]}")
    if with_xyz and c != 3:
        raise ValueError(f"with_xyz needs 3-d points, got c={c}")
    if not 1 <= k <= n - int(drop_first):
        raise ValueError(f"k={k} (+1 with drop_first) must lie in [1, n={n}]")
    if n + c > MAX_ROW_FLOATS:
        raise ValueError(
            f"knn_group kernel holds a query's n + c = {n + c} floats in "
            f"shared memory; the limit is {MAX_ROW_FLOATS}")


def knn_group_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
                   feats: torch.Tensor,
                   column_bias: torch.Tensor | None = None,
                   exact: bool = True, with_xyz: bool = True,
                   drop_first: bool = False):
    """Launch the kernel.  Same contract as :func:`knn_group_torch`."""
    from dispu_tpu_torch.kernels import _build

    _check(k, points, queries, feats, column_bias, with_xyz, drop_first)
    b, n, c = points.shape
    m, cf = queries.shape[1], feats.shape[2]
    dev = points.device
    bias = column_bias
    if bias is None:
        bias = torch.zeros((b, n), dtype=torch.float32, device=dev)
    dists = torch.empty((b, m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    gfeat = torch.empty((b, m, k, cf), dtype=torch.float32, device=dev)
    gxyz = (torch.empty((b, m, k, 3), dtype=torch.float32, device=dev)
            if with_xyz else None)
    fn = _build.load("knn_group").dispu_knn_group
    fn.argtypes = [_P] * 8 + [_I] * 8 + [_P]
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(points.data_ptr(), queries.data_ptr(), bias.data_ptr(),
                    feats.data_ptr(), dists.data_ptr(), idx.data_ptr(),
                    gxyz.data_ptr() if with_xyz else None, gfeat.data_ptr(),
                    b, n, m, c, cf, k, int(drop_first), int(exact), stream)
    _build.check(status, "knn_group kernel launch")
    LAUNCHES["knn_group"] += 1
    return dists, idx, gxyz, gfeat


def knn_group(k: int, points: torch.Tensor, queries: torch.Tensor,
              feats: torch.Tensor, column_bias: torch.Tensor | None = None,
              exact: bool = True, with_xyz: bool = True,
              drop_first: bool = False, impl: str = "auto"):
    """The k nearest ``points`` of each query and the gathered rows, as
    ``knn_group_pallas`` returns them: (dists, idx, grouped_xyz or None,
    grouped_feat).  The kernel for CUDA tensors, the plain version for CPU
    tensors.  Forward only: nothing carries a gradient (its backward rule
    comes with the GAN slice; training refuses the fused settings)."""
    args = (k, points.detach(), queries.detach(), feats.detach(),
            None if column_bias is None else column_bias.detach(), exact,
            with_xyz, drop_first)
    if use_kernel(impl, points):
        return knn_group_cuda(*args)
    return knn_group_torch(*args)
