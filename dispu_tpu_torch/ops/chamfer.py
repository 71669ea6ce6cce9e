"""Bidirectional nearest-neighbour distance, the Chamfer kernel (counterpart
of ``ops/chamfer.py``).

Each direction picks the nearest point by the expansion-form distances
(on the card the kNN kernel at k = 1, where the JAX package runs its
Pallas kNN), then recomputes the exact ``|p − q*|²`` from the matched
pair.  :class:`NnDistance` carries the JAX package's analytic backward,
``±2·g·(p − q*)`` scattered to both clouds.  :func:`nn_distance_chunked`
is the streaming form for whole clouds (evaluation).
"""

from __future__ import annotations

import torch

from dispu_tpu_torch.kernels import IMPLS
from dispu_tpu_torch.kernels.knn import knn
from dispu_tpu_torch.ops.geometry import pairwise_sq_dist
from dispu_tpu_torch.ops.sampling import gather_point

#: dataset sizes for which the argmin runs the kNN kernel on the card (the
#: JAX package's gate for its Pallas kNN)
KERNEL_MIN_N = 64
KERNEL_MAX_N = 4096


def directed_argmin(a: torch.Tensor, b: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """(b, n) int32 index of each (b, n, 3) ``a`` row's nearest (b, m, 3)
    ``b`` row, ties to the lower index.

    impl 'auto': the kNN kernel at k = 1 for CUDA tensors when
    64 ≤ m ≤ 4096, the plain first-occurrence argmin otherwise; 'cuda'
    insists on the kernel; 'torch' takes the plain argmin."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    a, b = a.detach(), b.detach()
    in_gate = KERNEL_MIN_N <= b.shape[-2] <= KERNEL_MAX_N
    if impl == "cuda" or (impl == "auto" and a.is_cuda and in_gate):
        return knn(1, b.contiguous(), a.contiguous(), impl="cuda")[1][..., 0]
    return torch.argmin(pairwise_sq_dist(a, b), dim=-1).to(torch.int32)


def _directed_min(a: torch.Tensor, b: torch.Tensor, impl: str):
    idx = directed_argmin(a, b, impl=impl)
    dist = torch.sum((a - gather_point(b, idx)) ** 2, dim=-1)
    return dist, idx


class NnDistance(torch.autograd.Function):
    """(dist1 (b, n), idx1 (b, n), dist2 (b, m), idx2 (b, m)) of clouds
    (b, n, 3) and (b, m, 3): squared distance to, and index of, each
    point's nearest neighbour in the other cloud.  The backward is the JAX
    package's ``_nn_distance_bwd``; the indices carry no gradient."""

    @staticmethod
    def forward(ctx, xyz1, xyz2, impl):
        dist1, idx1 = _directed_min(xyz1, xyz2, impl)
        dist2, idx2 = _directed_min(xyz2, xyz1, impl)
        ctx.save_for_backward(xyz1, xyz2, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return dist1, idx1, dist2, idx2

    @staticmethod
    def backward(ctx, g1, _g_idx1, g2, _g_idx2):
        xyz1, xyz2, idx1, idx2 = ctx.saved_tensors
        # d/dp |p − q*|² = 2 (p − q*); the matched q* receives the negation
        d1 = 2.0 * g1[..., None] * (xyz1 - gather_point(xyz2, idx1))
        d2 = 2.0 * g2[..., None] * (xyz2 - gather_point(xyz1, idx2))

        def scatter(like, idx, updates):
            index = idx.long()[..., None].expand_as(updates)
            return torch.zeros_like(like).scatter_add_(1, index, updates)

        return (d1 + scatter(xyz1, idx2, -d2), d2 + scatter(xyz2, idx1, -d1),
                None)


def nn_distance(xyz1: torch.Tensor, xyz2: torch.Tensor, impl: str = "auto"):
    """See :class:`NnDistance`."""
    return NnDistance.apply(xyz1, xyz2, impl)


def chamfer_distance(pred: torch.Tensor, gt: torch.Tensor, radius=1.0,
                     impl: str = "auto") -> torch.Tensor:
    """Symmetric mean Chamfer distance normalized by the patch radius: the
    mean over points in each direction, summed, divided by the radius,
    averaged over the batch."""
    dist_f, _, dist_b, _ = nn_distance(gt, pred, impl)
    cd = torch.mean(dist_f, dim=1) + torch.mean(dist_b, dim=1)
    return torch.mean(cd / radius)


@torch.no_grad()
def nn_distance_chunked(xyz1: torch.Tensor, xyz2: torch.Tensor,
                        chunk: int = 4096):
    """Streaming bidirectional NN distance for large clouds (counterpart of
    ``pallas_kernels.nn_distance_chunked``, which is XLA, not a kernel).

    The results of :func:`nn_distance`'s plain path, but no more than
    (chunk, m) of the distance matrix exists at a time: each block of
    ``chunk`` query rows takes its first-occurrence argmin on the
    expansion-form distances and the exact ``|p − q*|²`` of the matched
    pair.  No gradient (evaluation only).
    """
    def directed(a, b):
        dists, idxs = [], []
        for lo in range(0, a.shape[1], chunk):
            block = a[:, lo:lo + chunk]
            idx = torch.argmin(pairwise_sq_dist(block, b), dim=-1).to(
                torch.int32)
            dists.append(torch.sum((block - gather_point(b, idx)) ** 2,
                                   dim=-1))
            idxs.append(idx)
        return torch.cat(dists, dim=1), torch.cat(idxs, dim=1)

    d1, i1 = directed(xyz1, xyz2)
    d2, i2 = directed(xyz2, xyz1)
    return d1, i1, d2, i2
