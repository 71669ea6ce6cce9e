"""PointNet++ set abstraction and feature propagation (counterpart of
``nn/pointnet.py``).

Every selection runs on the port's ops, so on the card through the
kernels: FPS (``fps.cu``), the ball query (``query_ball.cu``) or the kNN
(``knn.cu``), and three-NN (``knn.cu`` at k 3).  flax infers each layer's
input width; here each module takes it (``in_features``: the width of
``points``, 0 for none) and names its own output width
(``out_features``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from dispu_tpu_torch.nn.layers import PointConv
from dispu_tpu_torch.ops.grouping import group_point, query_ball_point
from dispu_tpu_torch.ops.interpolate import (inverse_distance_weights,
                                             three_interpolate, three_nn)
from dispu_tpu_torch.ops.knn import knn_indices
from dispu_tpu_torch.ops.sampling import farthest_point_sample, gather_point

POOLINGS = ("max", "avg", "weighted_avg", "max_and_avg")


def grouped_width(in_features: int, use_xyz: bool) -> int:
    """The width of a grouped neighbourhood: the points' features with the
    centred xyz before them (``use_xyz``), or the centred xyz alone when
    there are no points (``in_features`` 0)."""
    if not in_features:
        return 3
    return in_features + 3 if use_xyz else in_features


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: Optional[torch.Tensor],
                     use_knn: bool = False, use_xyz: bool = True,
                     impl: str = "auto"):
    """FPS seeds, then each seed's ball (or kNN) neighbourhood with its xyz
    centred on the seed.  Returns (new_xyz (b, npoint, 3), new_points
    (b, npoint, nsample, c') with the centred xyz first, idx (b, npoint,
    nsample) int32, grouped_xyz (b, npoint, nsample, 3))."""
    new_xyz = gather_point(xyz, farthest_point_sample(npoint, xyz,
                                                      impl=impl))
    if use_knn:
        idx = knn_indices(nsample, xyz, new_xyz, impl=impl)
    else:
        idx, _ = query_ball_point(radius, nsample, xyz, new_xyz, impl=impl)
    grouped_xyz = group_point(xyz, idx) - new_xyz[:, :, None, :]
    if points is None:
        return new_xyz, grouped_xyz, idx, grouped_xyz
    grouped_points = group_point(points, idx)
    if use_xyz:
        grouped_points = torch.cat([grouped_xyz, grouped_points], dim=-1)
    return new_xyz, grouped_points, idx, grouped_xyz


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor],
                         use_xyz: bool = True):
    """One group of the whole cloud: new_xyz is zeros (b, 1, 3) and the
    grouped xyz is not centred.  Returns what :func:`sample_and_group`
    does, with npoint 1 and nsample n."""
    b, n, _ = xyz.shape
    new_xyz = xyz.new_zeros(b, 1, 3)
    grouped_xyz = xyz[:, None]
    if points is None:
        new_points = grouped_xyz
    elif use_xyz:
        new_points = torch.cat([xyz, points], dim=-1)[:, None]
    else:
        new_points = points[:, None]
    idx = torch.arange(n, dtype=torch.int32,
                       device=xyz.device)[None, None].expand(b, 1, n)
    return new_xyz, new_points, idx, grouped_xyz


def _pool(x: torch.Tensor, grouped_xyz: torch.Tensor,
          pooling: str) -> torch.Tensor:
    """Pool (b, s, k, c) over the neighbours."""
    if pooling == "max":
        return torch.amax(x, dim=2)
    if pooling == "avg":
        return torch.mean(x, dim=2)
    if pooling == "weighted_avg":
        dists = torch.linalg.vector_norm(grouped_xyz, dim=-1, keepdim=True)
        w = torch.exp(-dists * 5.0)
        w = w / torch.sum(w, dim=2, keepdim=True)
        return torch.sum(x * w, dim=2)
    return torch.cat([torch.amax(x, dim=2), torch.mean(x, dim=2)], dim=-1)


class PointNetSAModule(nn.Module):
    """Set abstraction: sample, group, a per-point MLP (``conv{i}``), pool
    ('max', 'avg', 'weighted_avg' with weights exp(−5·|xyz|) normalized
    over the neighbours, or 'max_and_avg', twice as wide), then the
    optional ``mlp2`` (``conv_post_{i}``).

    forward(xyz (b, n, 3), points (b, n, in_features) or None, npoint)
    → (new_xyz, new_points (b, npoint, out_features), idx).  ``npoint``
    given to forward takes the place of the module's (the hierarchy
    upsampler's layers sample a share of the input's points).
    """

    def __init__(self, in_features: int, npoint: Optional[int],
                 radius: float, nsample: int, mlp: Sequence[int],
                 mlp2: Optional[Sequence[int]] = None,
                 group_all: bool = False, pooling: str = "max",
                 use_knn: bool = False, use_xyz: bool = True,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 impl: str = "auto"):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling {pooling}")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all, self.pooling = group_all, pooling
        self.use_knn, self.use_xyz, self.impl = use_knn, use_xyz, impl
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        width = grouped_width(in_features, use_xyz)
        self.convs = len(mlp)
        for i, c in enumerate(mlp):
            self.add_module(f"conv{i}", PointConv(width, c, **kw))
            width = c
        if pooling == "max_and_avg":
            width *= 2
        self.posts = len(mlp2 or ())
        for i, c in enumerate(mlp2 or ()):
            self.add_module(f"conv_post_{i}", PointConv(width, c, **kw))
            width = c
        self.out_features = width

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                npoint: Optional[int] = None):
        if self.group_all:
            new_xyz, new_points, idx, grouped_xyz = sample_and_group_all(
                xyz, points, self.use_xyz)
        else:
            new_xyz, new_points, idx, grouped_xyz = sample_and_group(
                self.npoint if npoint is None else npoint, self.radius,
                self.nsample, xyz, points, self.use_knn, self.use_xyz,
                self.impl)
        for i in range(self.convs):
            new_points = getattr(self, f"conv{i}")(new_points)
        new_points = _pool(new_points, grouped_xyz, self.pooling)
        for i in range(self.posts):
            new_points = getattr(self, f"conv_post_{i}")(new_points)
        return new_xyz, new_points, idx


class PointNetSAModuleMSG(nn.Module):
    """Multi-scale set abstraction: one FPS, then for each scale i its ball
    (or kNN) group, the points' features before the centred xyz (the
    reverse of :func:`sample_and_group`'s order), the MLP ``conv{i}_{j}``
    and a max; the scales' features concatenated.

    forward(xyz, points or None) → (new_xyz, (b, npoint, out_features)).
    """

    def __init__(self, in_features: int, npoint: int,
                 radius_list: Sequence[float], nsample_list: Sequence[int],
                 mlp_list: Sequence[Sequence[int]], use_knn: bool = False,
                 use_xyz: bool = True, use_bn: bool = False,
                 bn_momentum: float = 0.95, impl: str = "auto"):
        super().__init__()
        self.npoint, self.radius_list = npoint, tuple(radius_list)
        self.nsample_list = tuple(nsample_list)
        self.mlp_lens = tuple(len(m) for m in mlp_list)
        self.use_knn, self.use_xyz, self.impl = use_knn, use_xyz, impl
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        self.out_features = 0
        for i, mlps in enumerate(mlp_list):
            width = grouped_width(in_features, use_xyz)
            for j, c in enumerate(mlps):
                self.add_module(f"conv{i}_{j}", PointConv(width, c, **kw))
                width = c
            self.out_features += width

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor]):
        new_xyz = gather_point(xyz, farthest_point_sample(
            self.npoint, xyz, impl=self.impl))
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list,
                                                  self.nsample_list)):
            if self.use_knn:
                idx = knn_indices(nsample, xyz, new_xyz, impl=self.impl)
            else:
                idx, _ = query_ball_point(radius, nsample, xyz, new_xyz,
                                          impl=self.impl)
            grouped_xyz = group_point(xyz, idx) - new_xyz[:, :, None, :]
            if points is None:
                grouped = grouped_xyz
            else:
                grouped = group_point(points, idx)
                if self.use_xyz:
                    grouped = torch.cat([grouped, grouped_xyz], dim=-1)
            for j in range(self.mlp_lens[i]):
                grouped = getattr(self, f"conv{i}_{j}")(grouped)
            outs.append(torch.amax(grouped, dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class PointNetFPModule(nn.Module):
    """Feature propagation: each point of xyz1 takes the inverse-distance
    mean of ``points2`` at its three nearest of xyz2 (width
    ``in_features``), ``points1`` (width ``skip_features``, 0 for none)
    after it, then the MLP ``conv_{i}``.

    forward(xyz1 (b, n, 3), xyz2 (b, m, 3), points1 or None, points2)
    → (b, n, out_features).
    """

    def __init__(self, in_features: int, skip_features: int,
                 mlp: Sequence[int], use_bn: bool = False,
                 bn_momentum: float = 0.95, impl: str = "auto"):
        super().__init__()
        self.impl = impl
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        width = in_features + skip_features
        self.convs = len(mlp)
        for i, c in enumerate(mlp):
            self.add_module(f"conv_{i}", PointConv(width, c, **kw))
            width = c
        self.out_features = width

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: Optional[torch.Tensor],
                points2: torch.Tensor) -> torch.Tensor:
        dist, idx = three_nn(xyz1, xyz2, impl=self.impl)
        out = three_interpolate(points2, idx, inverse_distance_weights(dist))
        if points1 is not None:
            out = torch.cat([out, points1], dim=-1)
        for i in range(self.convs):
            out = getattr(self, f"conv_{i}")(out)
        return out
