"""The spatial refiner core, ``PointShuffle2`` (counterpart of
``nn/refine.py``), composed path only.

  1. kNN-group xyz + features (k = ``nsample``; on the card the kNN
     kernel and one combined ``[xyz | feature]`` gather, or with
     ``gather_impl`` 'fused' / 'fused_turbo' the ``knn_group`` kernel;
     see ``ops.grouping.grouping``);
  2. local branch: per-edge MLP → pooling weights from ``WeightNetHidden``
     over the centred xyz → ``bnkt,bnkc->bntc`` pooling → k-major flatten
     → ``after_conv``, whose stored kernel rows stay (C', k)-major and are
     permuted at apply time;
  3. skip branch: max over the neighbours → dense;
  4. non-local branch: global attention over the whole cloud (the
     attention kernel on the card);
  5. the branches summed, then ``aggregation``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from dispu_tpu_torch.nn.attention import PointNonLocalCell
from dispu_tpu_torch.nn.layers import PointConv, WeightNetHidden
from dispu_tpu_torch.ops.grouping import grouping


class PointShuffle2(nn.Module):
    """Local + non-local refinement: xyz (b, n, 3), feature (b, n, c) →
    (xyz, (b, n, mlp[-1]))."""

    def __init__(self, in_features: int, nsample: int = 16,
                 mlp: Tuple[int, ...] = (128, 128, 256), use_bn: bool = False,
                 bn_momentum: float = 0.95, use_nonlocal: bool = True,
                 use_local: bool = True, gather_impl: str = "gather",
                 impl: str = "auto", knn_variant: str = "auto"):
        super().__init__()
        c, k, out_c = in_features, nsample, mlp[-1]
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        self.nsample, self.gather_impl, self.impl = k, gather_impl, impl
        self.knn_variant = knn_variant
        self.use_nonlocal, self.use_local = use_nonlocal, use_local
        if use_nonlocal:
            # 'nonlocal' is a Python keyword: the flax name needs add_module
            self.add_module("nonlocal", PointNonLocalCell(
                c, c, bottleneck=max(32, c // 2), out_features=out_c,
                impl=impl, **kw))
        grouped = 6 + c  # [centred xyz | raw xyz | feature]
        self.skip = PointConv(grouped, out_c, **kw)
        width = grouped
        for i, ch in enumerate(mlp[:-1]):
            self.add_module(f"conv{i}", PointConv(width, ch, **kw))
            width = ch
        self.num_convs = len(mlp) - 1
        self.weight_net = WeightNetHidden(3, (k,), bn_momentum=bn_momentum)
        # width entering the pooling: the last hidden conv's, or the raw
        # grouped width when mlp[:-1] is empty
        self.after_conv = PointConv(width * k, out_c,
                                    kernel_row_perm=(width, k), **kw)
        self.aggregation = PointConv(out_c, out_c, **kw)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor):
        b, n, _ = feature.shape
        grouped_xyz, grouped_feat, _ = grouping(
            feature, self.nsample, xyz, xyz, use_xyz=True,
            gather_impl=self.gather_impl, impl=self.impl,
            knn_variant=self.knn_variant,
        )
        centered = grouped_xyz - xyz[:, :, None, :]
        grouped_feat = torch.cat([centered, grouped_feat], dim=-1)

        if self.use_nonlocal:
            nl = getattr(self, "nonlocal")(feature, feature[:, None])[:, 0]
        if self.use_nonlocal and not self.use_local:
            y = nl
        else:
            skip = self.skip(torch.amax(grouped_feat, dim=2))
            y = grouped_feat
            for i in range(self.num_convs):
                y = getattr(self, f"conv{i}")(y)
            w = self.weight_net(centered)                  # (b, n, k, k)
            y = torch.einsum("bnkt,bnkc->bntc", w, y)
            y = self.after_conv(y.reshape(b, n, -1))       # k-major flatten
            y = y + skip
            if self.use_nonlocal:
                y = y + nl
        return xyz, self.aggregation(y)
