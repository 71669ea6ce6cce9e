"""Basic point-cloud geometry helpers (counterpart of ``ops/geometry.py``)."""

from __future__ import annotations

import math

import torch


def pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance matrix ``max(|x|² − 2x·y + |y|², 0)``.

    x: (..., n, c) queries, y: (..., m, c) dataset → (..., n, m).  The
    expansion and its association, ``(x2 − 2·xy) + y2``, are the JAX
    package's, so selections tie the same way.  The product runs in full
    f32: callers on the card pin ``allow_tf32 = False`` (see
    ``inference.pin_f32``).

    bf16 inputs (the feature kNN at bf16 compute) take the XLA form of
    the JAX package's jitted CPU path: each norm summed in f32 over the
    upcast values and rounded to bf16, the product of the upcast values
    in f32, and the rest in f32 (the result is f32).
    """
    if x.dtype == torch.bfloat16:
        x2, y2 = (torch.sum(t.float() * t.float(), dim=-1,
                            keepdim=True).to(t.dtype).float() for t in (x, y))
        xy = torch.matmul(x.float(), y.float().transpose(-1, -2))
        return torch.clamp_min(x2 - 2.0 * xy + y2.transpose(-1, -2), 0.0)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)            # (..., n, 1)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)            # (..., m, 1)
    xy = torch.matmul(x, y.transpose(-1, -2))              # (..., n, m)
    return torch.clamp_min(x2 - 2.0 * xy + y2.transpose(-1, -2), 0.0)


def normalize_point_cloud(pc: torch.Tensor):
    """Center on the centroid and scale by the furthest point distance.

    pc: (b, n, 3) or (n, 3) → (normalized, centroid, furthest) with
    broadcastable shapes.  A degenerate cloud (every point identical) is
    guarded by a 1e-12 floor on the scale.
    """
    squeeze = pc.dim() == 2
    if squeeze:
        pc = pc[None]
    centroid = torch.mean(pc, dim=1, keepdim=True)
    centered = pc - centroid
    furthest = torch.amax(
        torch.sqrt(torch.sum(centered ** 2, dim=-1, keepdim=True)),
        dim=1, keepdim=True,
    )
    out = centered / torch.clamp_min(furthest, 1e-12)
    if squeeze:
        return out[0], centroid[0], furthest[0]
    return out, centroid, furthest


def _grid_hw(up_ratio: int) -> tuple[int, int]:
    """Factor ``up_ratio`` into the most-square (num_x, num_y) grid."""
    sqrted = int(math.sqrt(up_ratio)) + 1
    for i in reversed(range(1, sqrted + 1)):
        if up_ratio % i == 0:
            return i, up_ratio // i
    return 1, up_ratio


def gen_grid(up_ratio: int) -> torch.Tensor:
    """(up_ratio, 2) float32 code grid in [-0.2, 0.2]², 'xy' meshgrid order."""
    num_x, num_y = _grid_hw(up_ratio)
    grid_x = torch.linspace(-0.2, 0.2, num_x, dtype=torch.float32)
    grid_y = torch.linspace(-0.2, 0.2, num_y, dtype=torch.float32)
    x, y = torch.meshgrid(grid_x, grid_y, indexing="xy")
    return torch.stack([x, y], dim=-1).reshape(-1, 2)


def gen_2d_grid(num_grid_point: int) -> torch.Tensor:
    """(num², 2) float32 square grid in [-0.2, 0.2]², 'xy' meshgrid
    order."""
    x = torch.linspace(-0.2, 0.2, num_grid_point, dtype=torch.float32)
    gx, gy = torch.meshgrid(x, x, indexing="xy")
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)


def gen_1d_grid(num_grid_point: int) -> torch.Tensor:
    """(1, num) float32 line code in [-0.02, 0.02]."""
    return torch.linspace(-0.02, 0.02, num_grid_point,
                          dtype=torch.float32)[None, :]


def covariance_matrix(pc: torch.Tensor):
    """Per-neighbourhood barycentre and 3×3 covariance: pc (b, p, k, 3) →
    (barycentre (b, p, 1, 3), centredᵀ·centred (b, p, 3, 3))."""
    barycenter = torch.mean(pc, dim=2, keepdim=True)
    centered = pc - barycenter
    return barycenter, torch.einsum("bpki,bpkj->bpij", centered, centered)


def exponential_distance(query: torch.Tensor, points: torch.Tensor):
    """Squared distances and a self-calibrated RBF affinity of broadcastable
    (b, p, k, 3) tensors: h is the mean over p of each row's smallest
    distance; returns (distance, exp(−d / (h/2))), both (b, p, k, 1)."""
    distance = torch.sum((query - points) ** 2, dim=-1, keepdim=True)
    h = torch.mean(torch.amin(distance, dim=2, keepdim=True), dim=1,
                   keepdim=True)
    return distance, torch.exp(-distance / (h / 2.0))
