"""EdgeConv / DenseGCN feature extraction (counterpart of ``nn/edgeconv.py``).

The backbone runs a feature-space kNN (k + 1 neighbours, duplicate rows
biased last, the first column dropped) in every dense block; on the card
that is the kNN kernel.  Only the 'concat' evaluation and the 'default'
block variant are ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dispu_tpu_torch.nn.layers import PointConv
from dispu_tpu_torch.ops.grouping import group_point
from dispu_tpu_torch.ops.knn import knn_unique_indices


def edge_parts(feature: torch.Tensor, k: int,
               idx: Optional[torch.Tensor] = None,
               gather_impl: str = "gather", impl: str = "auto"):
    """(center (b, n, c), neighbours (b, n, k, c), idx (b, n, k)): kNN in
    feature space with k + 1 neighbours, duplicates last, self dropped."""
    if idx is None:
        idx = knn_unique_indices(k + 1, feature, feature, impl=impl)[:, :, 1:]
    return feature, group_point(feature, idx, impl=gather_impl), idx


def edge_feature(feature: torch.Tensor, k: int,
                 idx: Optional[torch.Tensor] = None,
                 gather_impl: str = "gather", impl: str = "auto"):
    """Per-edge tensor ``[center, neighbour − center]`` (b, n, k, 2c) and
    the indices."""
    center, neighbors, idx = edge_parts(feature, k, idx, gather_impl, impl)
    center = center[:, :, None, :].expand_as(neighbors)
    return torch.cat([center, neighbors - center], dim=-1), idx


class DenseEdgeBlock(nn.Module):
    """Densely connected EdgeConv block with max aggregation over the
    neighbours: ``[conv(g) ‖ center, conv(g) ‖ prev, conv(g, linear) ‖
    prev]`` → 3g + c channels for dense_n = 3."""

    def __init__(self, in_features: int, growth_rate: int, n: int = 3,
                 k: int = 16, use_bn: bool = False, bn_momentum: float = 0.95,
                 gather_impl: str = "gather", impl: str = "auto"):
        super().__init__()
        self.n, self.k = n, k
        self.gather_impl, self.impl = gather_impl, impl
        width = 2 * in_features
        for i in range(n):
            self.add_module(f"l{i}", PointConv(
                width, growth_rate,
                activation=None if i == n - 1 else torch.relu,
                use_bn=use_bn, bn_momentum=bn_momentum))
            width = growth_rate + (in_features if i == 0 else width)
        self.out_features = width

    def forward(self, feature: torch.Tensor,
                idx: Optional[torch.Tensor] = None):
        y, idx = edge_feature(feature, self.k, idx, self.gather_impl,
                              self.impl)
        for i in range(self.n):
            conv = getattr(self, f"l{i}")
            if i == 0:
                center = feature[:, :, None, :].expand(
                    feature.shape[:2] + (y.shape[2], feature.shape[-1]))
                y = torch.cat([conv(y), center], dim=-1)
            else:
                y = torch.cat([conv(y), y], dim=-1)
        return torch.amax(y, dim=-2), idx


class FeatureExtractorGCN(nn.Module):
    """DenseGCN backbone: 24 → 120 → 240 → 360 → 480 channels at the
    defaults.  ``layer0`` lifts xyz to 24 channels (linear); each later
    block is preceded by a 1×1 compression to 2·growth (``layer{b}_prep``)
    and concatenated onto the running feature."""

    def __init__(self, in_features: int = 3, growth_rate: int = 24,
                 dense_block: int = 4, dense_n: int = 3, k: int = 16,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 gather_impl: str = "gather", impl: str = "auto"):
        super().__init__()
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        bkw = dict(gather_impl=gather_impl, impl=impl, **kw)
        comp = growth_rate * 2
        self.dense_block = dense_block
        self.layer0 = PointConv(in_features, 24, activation=None, **kw)
        self.layer1 = DenseEdgeBlock(24, growth_rate, dense_n, k, **bkw)
        width = self.layer1.out_features + 24
        for b in range(2, dense_block + 1):
            self.add_module(f"layer{b}_prep", PointConv(width, comp, **kw))
            block = DenseEdgeBlock(comp, growth_rate, dense_n, k, **bkw)
            self.add_module(f"layer{b}", block)
            width += block.out_features
        self.out_features = width

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        feat = self.layer0(xyz)
        out, _ = self.layer1(feat)
        out = torch.cat([out, feat], dim=-1)
        for b in range(2, self.dense_block + 1):
            prep = getattr(self, f"layer{b}_prep")(out)
            block, _ = getattr(self, f"layer{b}")(prep)
            out = torch.cat([block, out], dim=-1)
        return out
