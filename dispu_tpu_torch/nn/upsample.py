"""Feature duplication upsampling and coordinate regression heads
(counterpart of ``nn/upsample.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dispu_tpu_torch.nn.layers import PointConv, scalar
from dispu_tpu_torch.ops.geometry import gen_grid


class DuplicateUp(nn.Module):
    """r-fold feature duplication with a 2-D grid code, then conv 256 →
    conv 128 (ReLU).  Output point ``r·N + n`` carries the feature of
    input point ``n`` and grid code ``r`` (r-major order).  The grid
    takes the feature's dtype, so at bf16 compute it is rounded to bf16,
    as the JAX package rounds it to the compute dtype."""

    def __init__(self, in_features: int, up_ratio: int = 4,
                 hidden: int = 256, out_features: int = 128):
        super().__init__()
        self.up_ratio = up_ratio
        self.conv1 = PointConv(in_features + 2, hidden)
        self.conv2 = PointConv(hidden, out_features)
        self.out_features = out_features

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        b, n, _ = feature.shape
        grid = gen_grid(self.up_ratio).to(feature)           # (r, 2)
        grid = torch.repeat_interleave(grid, n, dim=0)        # (r·n, 2)
        grid = grid[None].expand(b, -1, -1)
        net = feature.repeat(1, self.up_ratio, 1)             # (b, r·n, c)
        net = torch.cat([net, grid], dim=-1)
        return self.conv2(self.conv1(net))


class CoordinateRegressor(nn.Module):
    """Per-point MLP 256 → 64 → 3 regressing xyz; with ``offset_range`` the
    output is squashed to ``sigmoid(x)·2·range − range``, in the compute
    dtype: at bf16 the scalars round to it first, as JAX's weak-typed
    ones, and the sigmoid is XLA's ``1 / (1 + exp(−x))`` with each op
    rounded."""

    def __init__(self, in_features: int, offset_range: Optional[float] = None,
                 hidden0: int = 256, hidden1: int = 64):
        super().__init__()
        self.offset_range = offset_range
        self.fc_layer0 = PointConv(in_features, hidden0)
        self.fc_layer1 = PointConv(hidden0, hidden1)
        self.fc_layer2 = PointConv(hidden1, 3, activation=None)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        x = self.fc_layer2(self.fc_layer1(self.fc_layer0(feature)))
        if self.offset_range is not None:
            r = self.offset_range
            if x.dtype == torch.float32:
                s = torch.sigmoid(x)
            else:
                one = scalar(1.0, x)
                s = one / (one + torch.exp(-x))
            x = s * scalar(2.0 * r, x) - scalar(r, x)
        return x
