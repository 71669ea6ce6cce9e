"""EdgeConv / DenseGCN feature extraction (counterpart of ``nn/edgeconv.py``).

The backbone runs a feature-space kNN (k + 1 neighbours, duplicate rows
biased last, the first column dropped) in every dense block; on the card
that is the kNN kernel, or with ``gather_impl`` 'fused' / 'fused_turbo'
the ``knn_group`` kernel, which gathers the neighbours in the same pass.
Both evaluations of a block are ported, 'concat' and the part-split
'split', each with the three block variants ('default', 'v0', 'v2');
and the single EdgeConv layer of the experimental modules.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dispu_tpu_torch.kernels import knn_group as _knn_group
from dispu_tpu_torch.nn.layers import PointConv
from dispu_tpu_torch.ops.grouping import group_point
from dispu_tpu_torch.ops.knn import knn_unique_indices, mask_duplicate_rows

DENSE_IMPLS = ("concat", "split")
#: 'default' (``dense_conv``), 'v0' (``dense_conv0``: layer 0 does not
#: carry the centre on) and 'v2' (``dense_conv2``: the last layer keeps its
#: ReLU)
VARIANTS = ("default", "v0", "v2")


def edge_parts(feature: torch.Tensor, k: int,
               idx: Optional[torch.Tensor] = None,
               gather_impl: str = "gather", impl: str = "auto",
               knn_variant: str = "auto"):
    """(center (b, n, c), neighbours (b, n, k, c), idx (b, n, k)): kNN in
    feature space with k + 1 neighbours, duplicates last, self dropped.

    ``gather_impl`` 'fused' / 'fused_turbo' without a given ``idx`` runs
    the ``knn_group`` kernel (``drop_first``, duplicates biased by 1e30,
    features only; turbo rounds them to bf16) inside the JAX package's
    gate (64 ≤ n ≤ 2048, c ≤ 384, k + 1 ≤ 128), and the composed
    'onehot_hp' / 'onehot' path elsewhere."""
    fused = gather_impl in ("fused", "fused_turbo")
    if idx is None and fused:
        n, c = feature.shape[-2:]
        if 64 <= n <= 2048 and c <= _knn_group.MAX_C and k + 1 <= 128:
            feature = feature.contiguous()
            dup = mask_duplicate_rows(feature.detach())
            _, idx, _, neighbors = _knn_group.knn_group(
                k, feature, feature, feature, dup.to(torch.float32) * 1e30,
                exact=gather_impl == "fused", with_xyz=False, drop_first=True,
                impl=impl)
            return feature, neighbors, idx
    if fused:
        gather_impl = "onehot_hp" if gather_impl == "fused" else "onehot"
    if idx is None:
        idx = knn_unique_indices(k + 1, feature, feature, impl=impl,
                                 variant=knn_variant)[:, :, 1:]
    return feature, group_point(feature, idx, gather_impl, impl=impl), idx


def edge_feature(feature: torch.Tensor, k: int,
                 idx: Optional[torch.Tensor] = None,
                 gather_impl: str = "gather", impl: str = "auto",
                 knn_variant: str = "auto"):
    """Per-edge tensor ``[center, neighbour − center]`` (b, n, k, 2c) and
    the indices."""
    center, neighbors, idx = edge_parts(feature, k, idx, gather_impl, impl,
                                        knn_variant)
    center = center[:, :, None, :].expand_as(neighbors)
    return torch.cat([center, neighbors - center], dim=-1), idx


class _SplitPointConv(PointConv):
    """A :class:`PointConv` applied to row-partitioned inputs (the JAX
    package's ``_SplitPointConv`` over ``_PartsDense``): the same
    parameters (``dense``, optional ``bn``), so that a flax tree and a
    checkpoint map onto either form.  ``parts`` holds, for each row block
    of the kernel (``part_rows``), a list of (tensor, sign) terms; the
    terms' products are summed in the JAX package's order, then the bias
    is added.  ``concat([a, b]) @ W = a @ W_a + b @ W_b`` in real
    arithmetic; in f32 only the sum order differs."""

    def __init__(self, part_rows, features: int, **kw):
        super().__init__(sum(part_rows), features, **kw)
        self.part_rows = tuple(part_rows)

    def forward(self, parts) -> torch.Tensor:
        dt = self.compute_dtype                         # every op at it
        weight = self.dense.weight.to(dt)               # (features, in)
        x, off = None, 0
        for rows, terms in zip(self.part_rows, parts):
            w = weight[:, off:off + rows].t()
            off += rows
            for a, sign in terms:
                t = torch.matmul(a.to(dt), w)
                t = -t if sign < 0 else t
                x = t if x is None else x + t
        x = x + self.dense.bias.to(dt)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class DenseEdgeBlock(nn.Module):
    """Densely connected EdgeConv block with max aggregation over the
    neighbours: ``[conv(g) ‖ center, conv(g) ‖ prev, conv(g, linear) ‖
    prev]`` → 3g + c channels for dense_n = 3.

    ``dense_impl`` 'concat' evaluates that dataflow literally; 'split'
    distributes each conv over its concat parts, so the center enters
    as (b, n, 1, c) and only the (b, n, k, g) conv outputs are formed
    (``DenseEdgeBlock._split`` of the JAX package).  Same parameters.

    ``variant`` 'v0' leaves the centre out of layer 0's output (n·g
    channels out, no centre term anywhere after the edge tensor); 'v2'
    keeps the last layer's ReLU."""

    def __init__(self, in_features: int, growth_rate: int, n: int = 3,
                 k: int = 16, use_bn: bool = False, bn_momentum: float = 0.95,
                 gather_impl: str = "gather", impl: str = "auto",
                 knn_variant: str = "auto", dense_impl: str = "concat",
                 variant: str = "default"):
        super().__init__()
        if dense_impl not in DENSE_IMPLS:
            raise ValueError(f"unknown dense_impl {dense_impl!r}")
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.n, self.k = n, k
        self.gather_impl, self.impl = gather_impl, impl
        self.knn_variant, self.dense_impl = knn_variant, dense_impl
        self.variant = variant
        c, g = in_features, growth_rate
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        center = () if variant == "v0" else (c,)
        for i in range(n):
            act = (None if i == n - 1 and variant != "v2" else torch.relu)
            # layer inputs: [center | nbr − center], then [out_{i−1} | …
            # | out_0 | center]
            rows = (c, c) if i == 0 else (g,) * i + center
            conv = (_SplitPointConv(rows, g, activation=act, **kw)
                    if dense_impl == "split"
                    else PointConv(sum(rows), g, activation=act, **kw))
            self.add_module(f"l{i}", conv)
        self.out_features = n * g + len(center) * c

    def forward(self, feature: torch.Tensor,
                idx: Optional[torch.Tensor] = None):
        if self.dense_impl == "split":
            return self._split(feature, idx)
        y, idx = edge_feature(feature, self.k, idx, self.gather_impl,
                              self.impl, self.knn_variant)
        for i in range(self.n):
            conv = getattr(self, f"l{i}")
            if i == 0 and self.variant == "v0":
                y = conv(y)
            elif i == 0:
                center = feature[:, :, None, :].expand(
                    feature.shape[:2] + (y.shape[2], feature.shape[-1]))
                y = torch.cat([conv(y), center], dim=-1)
            else:
                y = torch.cat([conv(y), y], dim=-1)
        return torch.amax(y, dim=-2), idx

    def _split(self, feature: torch.Tensor, idx: Optional[torch.Tensor]):
        """The max over k distributes over the output concat, and the
        tiled center's max is the center itself ('v0' carries no center
        after layer 0)."""
        center, nbr, idx = edge_parts(feature, self.k, idx, self.gather_impl,
                                      self.impl, self.knn_variant)
        c1 = center[:, :, None, :]  # (b, n, 1, c): the k-independent terms
        outs = []
        for i in range(self.n):
            if i == 0:
                parts = [[(c1, +1)], [(nbr, +1), (c1, -1)]]
            else:  # out_{i−1} first, as in the concat
                parts = [[(o, +1)] for o in outs[::-1]]
                if self.variant != "v0":
                    parts.append([(c1, +1)])
            outs.append(getattr(self, f"l{i}")(parts))
        pieces = [torch.amax(o, dim=-2) for o in outs[::-1]]
        if self.variant != "v0":
            pieces.append(center)
        return torch.cat(pieces, dim=-1), idx


class EdgeConv(nn.Module):
    """A single EdgeConv layer (DGCNN): the edge tensor of the feature-space
    kNN graph, one ReLU :class:`PointConv` ``conv`` to ``features``, the
    max over the neighbours.  (b, n, in_features) → (b, n, features)."""

    def __init__(self, in_features: int, features: int, k: int = 16,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 impl: str = "auto"):
        super().__init__()
        self.k, self.impl = k, impl
        self.conv = PointConv(2 * in_features, features, use_bn=use_bn,
                              bn_momentum=bn_momentum)
        self.out_features = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        edges, _ = edge_feature(x, self.k, impl=self.impl)
        return torch.amax(self.conv(edges), dim=-2)


class FeatureExtractorGCN(nn.Module):
    """DenseGCN backbone: 24 → 120 → 240 → 360 → 480 channels at the
    defaults.  ``layer0`` lifts xyz to 24 channels (linear); each later
    block is preceded by a 1×1 compression to 2·growth (``layer{b}_prep``)
    and concatenated onto the running feature."""

    def __init__(self, in_features: int = 3, growth_rate: int = 24,
                 dense_block: int = 4, dense_n: int = 3, k: int = 16,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 gather_impl: str = "gather", impl: str = "auto",
                 knn_variant: str = "auto", dense_impl: str = "concat"):
        super().__init__()
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        bkw = dict(gather_impl=gather_impl, impl=impl,
                   knn_variant=knn_variant, dense_impl=dense_impl, **kw)
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
