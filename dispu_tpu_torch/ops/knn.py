"""k-nearest-neighbour search (counterpart of ``ops/knn.py``).

On the card every kNN of the serving path goes through the kNN kernels
(``kernels/knn.py``), including patch extraction with k = 256, which the
JAX package leaves to XLA's ``top_k``; on the CPU the kernels' plain
versions run.  ``variant="packed"`` (the turbo selection) takes the packed
kernel where the JAX package's gate admits its Pallas kernel, and the exact
selection elsewhere.  Indices come back int32, distances ascending.

bf16 points (the feature kNN at bf16 compute) are upcast to f32 exactly
for the kernels, as ``knn_pallas`` does; on the CPU ``impl='auto'`` keeps
the JAX package's CPU form (:func:`knn_xla`), where the norms round to
bf16.
"""

from __future__ import annotations

import torch

from dispu_tpu_torch.kernels.knn import duplicate_rows_op as _duplicate_rows
from dispu_tpu_torch.kernels.knn import knn as _knn_kernel
from dispu_tpu_torch.kernels.knn import knn_packed as _knn_packed
from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

VARIANTS = ("auto", "packed")


def mask_duplicate_rows(points: torch.Tensor) -> torch.Tensor:
    """(..., n, c) → (..., n) bool: True where an identical row exists at a
    smaller index (rows of finite values; -0.0 equals 0.0).  The op
    ``dispu_tpu_torch::duplicate_rows``
    (:func:`dispu_tpu_torch.kernels.knn.duplicate_rows_torch`), one node
    of an exported graph."""
    return _duplicate_rows(points)


def _use_packed(variant: str, points: torch.Tensor, k: int) -> bool:
    """Whether ``variant`` takes the packed selection at this shape: the
    JAX package's gate for its Pallas kernel (``_use_pallas``: 64 ≤ n ≤
    4096, c ≤ 128, k ≤ 128), without its backend test."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    return (variant == "packed" and points.dim() == 3
            and 64 <= points.shape[-2] <= 4096 and points.shape[-1] <= 128
            and k <= 128)


def _select(k, points, queries, bias, impl, variant):
    if points.dtype == torch.bfloat16:
        # bf16 features: on the CPU ('auto') the JAX package's CPU path,
        # XLA's exact selection over the bf16 form of the distances
        # (``geometry.pairwise_sq_dist``); elsewhere ``knn_pallas``'s,
        # the values upcast to f32 exactly, then the f32 selection
        if impl == "auto" and not points.is_cuda:
            return knn_xla(k, points, queries, bias)
        points, queries = points.float(), queries.float()
    points, queries = points.contiguous(), queries.contiguous()
    if _use_packed(variant, points, k):
        return _knn_packed(k, points, queries, bias, impl=impl)
    return _knn_kernel(k, points, queries, bias, impl=impl)


def knn_xla(k: int, points: torch.Tensor, queries: torch.Tensor,
            bias: torch.Tensor | None = None):
    """The XLA form of the JAX package's ``knn`` off the TPU: the distance
    matrix of :func:`~dispu_tpu_torch.ops.geometry.pairwise_sq_dist` in
    the inputs' dtype, the (b, n) column bias added, and the exact
    selection ascending, ties to the lower index.  Not differentiable in
    its selection; the distances are, through autograd."""
    d = pairwise_sq_dist(queries, points)
    if bias is not None:
        d = d + bias[..., None, :]
    d, idx = torch.sort(d, dim=-1, stable=True)
    return d[..., :k], idx[..., :k].to(torch.int32)


def knn(k: int, points: torch.Tensor, queries: torch.Tensor,
        impl: str = "auto", variant: str = "auto"):
    """(b, n, c) points, (b, m, c) queries → ((b, m, k) squared distances
    ascending, (b, m, k) int32 indices); ties go to the lower index.  The
    distances are differentiable with the selection held fixed
    (``kernels.knn.KnnFunction``); the packed ones are truncated, and
    their gradient is the exact rule's at the packed selection."""
    return _select(k, points, queries, None, impl, variant)


def knn_indices(k: int, points: torch.Tensor, queries: torch.Tensor,
                impl: str = "auto", variant: str = "auto") -> torch.Tensor:
    """Neighbour indices only, detached from autograd."""
    return knn(k, points.detach(), queries.detach(), impl, variant)[1]


def knn_unique(k: int, points: torch.Tensor, queries: torch.Tensor,
               impl: str = "auto", variant: str = "auto"):
    """kNN in which rows that duplicate an earlier row sort last: their
    columns carry a bias of 1e30, as on the JAX package's Pallas path, so
    each distinct point is returned at most once unless fewer than k
    distinct points exist."""
    dup = mask_duplicate_rows(points.detach().float())  # bf16 rows upcast
    bias = dup.to(torch.float32) * 1e30
    return _select(k, points, queries, bias, impl, variant)


def knn_unique_indices(k: int, points: torch.Tensor, queries: torch.Tensor,
                       impl: str = "auto",
                       variant: str = "auto") -> torch.Tensor:
    """``knn_unique`` indices only, detached from autograd."""
    return knn_unique(k, points.detach(), queries.detach(), impl, variant)[1]
