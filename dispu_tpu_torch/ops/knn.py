"""Exact k-nearest-neighbour search (counterpart of ``ops/knn.py``).

On the card every kNN of the serving path goes through the one kNN kernel
(``kernels/knn.py``), including patch extraction with k = 256, which the
JAX package leaves to XLA's ``top_k``; on the CPU the kernel's plain
version runs.  Indices come back int32, distances ascending.
"""

from __future__ import annotations

import torch

from dispu_tpu_torch.kernels.knn import knn as _knn_kernel


def mask_duplicate_rows(points: torch.Tensor) -> torch.Tensor:
    """(..., n, c) → (..., n) bool: True where an identical row exists at a
    smaller index (rows of finite values; -0.0 equals 0.0).

    One lexicographic sort groups identical rows (``torch.unique`` over
    rows, with the cloud's index as a leading column, exact below 2²⁴
    clouds); a row is marked unless it has the smallest index of its
    group.  No (..., n, n) plane is formed."""
    n, c = points.shape[-2:]
    flat = points.reshape(-1, c)
    index = torch.arange(flat.shape[0], device=points.device)
    cloud = torch.div(index, n, rounding_mode="floor").to(points.dtype)
    _, group = torch.unique(torch.cat([cloud[:, None], flat], dim=1), dim=0,
                            return_inverse=True)
    first = torch.full_like(index, flat.shape[0]).scatter_reduce_(
        0, group, index, "amin")
    return (first[group] != index).reshape(points.shape[:-1])


def knn(k: int, points: torch.Tensor, queries: torch.Tensor,
        impl: str = "auto"):
    """(b, n, c) points, (b, m, c) queries → ((b, m, k) squared distances
    ascending, (b, m, k) int32 indices); ties go to the lower index.  The
    distances are differentiable (``kernels.knn.KnnFunction``)."""
    return _knn_kernel(k, points.contiguous(), queries.contiguous(),
                       impl=impl)


def knn_indices(k: int, points: torch.Tensor, queries: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """Neighbour indices only, detached from autograd."""
    return knn(k, points.detach(), queries.detach(), impl)[1]


def knn_unique(k: int, points: torch.Tensor, queries: torch.Tensor,
               impl: str = "auto"):
    """kNN in which rows that duplicate an earlier row sort last: their
    columns carry a bias of 1e30, as on the JAX package's Pallas path, so
    each distinct point is returned at most once unless fewer than k
    distinct points exist."""
    points = points.contiguous()
    bias = mask_duplicate_rows(points.detach()).to(torch.float32) * 1e30
    return _knn_kernel(k, points, queries.contiguous(), bias, impl=impl)


def knn_unique_indices(k: int, points: torch.Tensor, queries: torch.Tensor,
                       impl: str = "auto") -> torch.Tensor:
    """``knn_unique`` indices only, detached from autograd."""
    return knn_unique(k, points.detach(), queries.detach(), impl)[1]
