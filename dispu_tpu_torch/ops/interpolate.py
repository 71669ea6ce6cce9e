"""3-NN inverse-distance feature interpolation, PointNet++'s feature
propagation (counterpart of ``ops/interpolate.py``).

The three nearest neighbours come from the port's kNN (the kNN kernel on
the card, its plain version on the CPU), so ties go to the lower index
as in ``lax.top_k``; the weighted gather is plain torch and
differentiable through autograd.
"""

from __future__ import annotations

import torch

from dispu_tpu_torch.ops.knn import knn


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor, impl: str = "auto"):
    """The three nearest of (b, m, 3) ``xyz2`` to each (b, n, 3) query of
    ``xyz1`` → ((b, n, 3) squared distances ascending, (b, n, 3) int32
    indices).  With fewer than three points the nearest is repeated."""
    k = min(3, xyz2.shape[-2])
    dist, idx = knn(k, xyz2.float(), xyz1.float(), impl=impl)
    if k < 3:
        dist = torch.cat([dist, dist[..., :1].expand(
            *dist.shape[:-1], 3 - k)], dim=-1)
        idx = torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1], 3 - k)],
                        dim=-1)
    return dist, idx


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(b, m, c) source features, (b, n, 3) indices and weights → (b, n, c)
    weighted sums of the three rows."""
    b, n, k = idx.shape
    rows = torch.gather(points, 1, idx.long().reshape(b, n * k, 1).expand(
        -1, -1, points.shape[-1])).reshape(b, n, k, points.shape[-1])
    return torch.sum(rows * weight[..., None], dim=2)


def inverse_distance_weights(dist: torch.Tensor,
                             eps: float = 1e-10) -> torch.Tensor:
    """1/d weights normalized over the last axis, d floored at ``eps``."""
    inv = 1.0 / torch.clamp_min(dist, eps)
    return inv / torch.sum(inv, dim=-1, keepdim=True)
