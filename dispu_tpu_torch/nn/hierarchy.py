"""Hierarchical (PointNet++ U-Net) feature extractors (counterpart of
``nn/hierarchy.py``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dispu_tpu_torch.nn.layers import PointConv
from dispu_tpu_torch.nn.pointnet import PointNetFPModule, PointNetSAModule


class HierarchyFeatureExtractor(nn.Module):
    """Three SA levels (mlps (32, 32, 64), (64, 64, 128), (128, 128, 256)
    at ``npoints`` and ``radius``), a group_all (256, 256, 512) level,
    then FP back to the input points: (512, 512), (512, 256), (256, 128),
    (128, 128, 128).  (b, n, 3) → (b, n, 128)."""

    def __init__(self, npoints: Sequence[int] = (1024, 384, 128),
                 radius: Sequence[float] = (0.1, 0.2, 0.4),
                 nsample: int = 64, use_bn: bool = False,
                 bn_momentum: float = 0.95, impl: str = "auto"):
        super().__init__()
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum, impl=impl)
        mlps = ((32, 32, 64), (64, 64, 128), (128, 128, 256))
        width, widths = 0, []
        for i, (npoint, r, mlp) in enumerate(zip(npoints, radius, mlps)):
            layer = PointNetSAModule(width, npoint, r, nsample, mlp, **kw)
            self.add_module(f"layer{i + 1}", layer)
            widths.append(width)
            width = layer.out_features
        self.layer4 = PointNetSAModule(width, 1, 0.0, 1, (256, 256, 512),
                                       group_all=True, **kw)
        widths.append(width)
        width = self.layer4.out_features
        # fa_layer{j} brings level 4 − j up to level 3 − j
        for j, mlp in enumerate(((512, 512), (512, 256), (256, 128),
                                 (128, 128, 128))):
            fp = PointNetFPModule(width, widths[3 - j], mlp, **kw)
            self.add_module(f"fa_layer{j + 1}", fp)
            width = fp.out_features
        self.out_features = width

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        xyz, points = [inputs], [None]
        for i in range(4):
            new_xyz, new_points, _ = getattr(self, f"layer{i + 1}")(
                xyz[-1], points[-1])
            xyz.append(new_xyz)
            points.append(new_points)
        up = points[4]
        for j in range(4):
            up = getattr(self, f"fa_layer{j + 1}")(
                xyz[3 - j], xyz[4 - j], points[3 - j], up)
        return up


class HierarchyUpsampler(nn.Module):
    """PU-Net-style upsampler over an SA/FP pyramid: SA levels at n, n/2,
    n/4 and n/8 points (radius ``bradius`` × 0.05, 0.1, 0.2, 0.3; 32
    neighbours), levels 2–4 brought back to the input points by FP (64
    each), those three, level 1's features and the xyz concatenated (259
    wide), then ``up_ratio`` branches ``fc_layer0_{i}`` (256, no batch
    norm) → ``conv_{i}`` (128) stacked along the point axis, and
    ``fc_layer1`` (64) → ``fc_layer2`` (3, linear), neither with batch
    norm.  (b, n, 3) → (b, up_ratio·n, 3)."""

    def __init__(self, up_ratio: int = 4, bradius: float = 1.0,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 impl: str = "auto"):
        super().__init__()
        self.up_ratio = up_ratio
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        width, fp_widths = 0, []
        for i, (r, mlp) in enumerate(zip(
                (0.05, 0.1, 0.2, 0.3),
                ((32, 32, 64), (64, 64, 128), (128, 128, 256),
                 (256, 256, 512)))):
            # npoint is the forward's, from the input
            layer = PointNetSAModule(width, None, bradius * r, 32, mlp,
                                     impl=impl, **kw)
            self.add_module(f"layer{i + 1}", layer)
            width = layer.out_features
            fp_widths.append(width)
        for j in range(3):  # fa_layer{j} brings level 4 − j up
            self.add_module(f"fa_layer{j + 1}", PointNetFPModule(
                fp_widths[3 - j], 0, (64,), impl=impl, **kw))
        width = 3 * 64 + fp_widths[0] + 3
        for i in range(up_ratio):
            self.add_module(f"fc_layer0_{i}", PointConv(width, 256))
            self.add_module(f"conv_{i}", PointConv(256, 128, **kw))
        self.fc_layer1 = PointConv(128, 64)
        self.fc_layer2 = PointConv(64, 3, activation=None)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        n = inputs.shape[1]
        xyz, points = [inputs], [None]
        for i, npoint in enumerate((n, n // 2, n // 4, n // 8)):
            new_xyz, new_points, _ = getattr(self, f"layer{i + 1}")(
                xyz[-1], points[-1], npoint)
            xyz.append(new_xyz)
            points.append(new_points)
        ups = [getattr(self, f"fa_layer{j + 1}")(inputs, xyz[4 - j], None,
                                                 points[4 - j])
               for j in range(3)]
        concat = torch.cat([*ups, points[1], inputs], dim=-1)
        net = torch.cat([getattr(self, f"conv_{i}")(
            getattr(self, f"fc_layer0_{i}")(concat))
            for i in range(self.up_ratio)], dim=1)
        return self.fc_layer2(self.fc_layer1(net))
