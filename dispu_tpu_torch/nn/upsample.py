"""Feature duplication upsampling, the PU-GAN up/down blocks and
coordinate regression heads (counterpart of ``nn/upsample.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dispu_tpu_torch.nn.attention import AttentionUnit
from dispu_tpu_torch.nn.layers import PointConv, scalar
from dispu_tpu_torch.ops.geometry import gen_grid


def duplicate_with_grid(feature: torch.Tensor,
                        up_ratio: int) -> torch.Tensor:
    """(b, n, c) → (b, r·n, c + 2): the features tiled r times, r-major,
    each copy with its 2-D grid code after it, in the features' dtype."""
    b, n, _ = feature.shape
    grid = gen_grid(up_ratio).to(feature)                  # (r, 2)
    grid = torch.repeat_interleave(grid, n, dim=0)          # (r·n, 2)
    net = feature.repeat(1, up_ratio, 1)                    # (b, r·n, c)
    return torch.cat([net, grid[None].expand(b, -1, -1)], dim=-1)


def fold(feature: torch.Tensor, up_ratio: int) -> torch.Tensor:
    """(b, r·n, c) in r-major order → (b, n, r, c)."""
    b, rn, c = feature.shape
    return feature.reshape(b, up_ratio, rn // up_ratio, c).transpose(1, 2)


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
        return self.conv2(self.conv1(duplicate_with_grid(feature,
                                                         self.up_ratio)))


class ContractExpand(nn.Module):
    """Fold the r duplicates of each point, mix, re-expand: (b, r·n, c) →
    (b, n, r·c) → ``down_conv1`` (c) → ``down_conv2`` (r·c) → (b, n, r, c)
    → ``down_conv3`` (c) → (b, r·n, c), ReLU throughout."""

    def __init__(self, in_features: int, up_ratio: int = 4):
        super().__init__()
        c, r = in_features, up_ratio
        self.up_ratio = r
        self.down_conv1 = PointConv(r * c, c)
        self.down_conv2 = PointConv(c, c * r)
        self.down_conv3 = PointConv(c, c)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        b, rn, c = inputs.shape
        r = self.up_ratio
        net = self.down_conv1(fold(inputs, r).reshape(b, rn // r, r * c))
        net = self.down_conv3(self.down_conv2(net).reshape(b, rn // r, r, c))
        return net.transpose(1, 2).reshape(b, rn, c)


class UpBlock(nn.Module):
    """PU-GAN up block: r-fold duplication with the grid code, the
    self-attention unit ``attention``, then conv 256 → conv 128 (ReLU).
    (b, n, c) → (b, r·n, 128)."""

    def __init__(self, in_features: int, up_ratio: int = 4):
        super().__init__()
        self.up_ratio = up_ratio
        self.attention = AttentionUnit(in_features + 2)
        self.conv1 = PointConv(in_features + 2, 256)
        self.conv2 = PointConv(256, 128)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        net = self.attention(duplicate_with_grid(feature, self.up_ratio))
        return self.conv2(self.conv1(net))


class DownBlock(nn.Module):
    """PU-GAN down block: the r duplicates of each point folded into one
    (b, n, r·c) row (r-major), then conv 256 → conv 128 (ReLU)."""

    def __init__(self, in_features: int, up_ratio: int = 4):
        super().__init__()
        self.up_ratio = up_ratio
        self.conv1 = PointConv(up_ratio * in_features, 256)
        self.conv2 = PointConv(256, 128)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        b, rn, c = feature.shape
        net = fold(feature, self.up_ratio).reshape(
            b, rn // self.up_ratio, self.up_ratio * c)
        return self.conv2(self.conv1(net))


class UpProjectionUnit(nn.Module):
    """Back-projection upsampler: L = conv0 (128), H0 = up(L), H1 =
    up(down(H0) − L), H0 + H1.  (b, n, c) → (b, r·n, 128)."""

    def __init__(self, in_features: int, up_ratio: int = 4):
        super().__init__()
        self.conv0 = PointConv(in_features, 128)
        self.up_0 = UpBlock(128, up_ratio)
        self.down_0 = DownBlock(128, up_ratio)
        self.up_1 = UpBlock(128, up_ratio)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        low = self.conv0(feature)
        h0 = self.up_0(low)
        return h0 + self.up_1(self.down_0(h0) - low)


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
