"""The reference's experimental op families (counterpart of
``nn/experimental.py``): alternative down- and up-scalers, the
shuffle-based upsamplers, the refiner's first iteration, and the odd
normalisation and reconstruction units.  No model path calls them.

Flax infers every width at its first call; here each module takes its
input width (``in_features``) and computes the rest, with the flax
tree's scope names, so ``convert.from_flax_variables`` maps one onto the
other.  Where a parameter's shape depends on the input's point count as
well, the module takes that count too (``in_points``) and refuses
another.

The JAX package repairs four latent faults of the reference, and so does
the port, the same way: ``PointASNLSetAbstraction``'s undefined
``nl_channel`` is ``mlp[-1]``; ``PointShuffleV1`` sizes its weight head
from the feature channels, not the xyz channels; ``WeightLearningUnit``
projects its weights back to the input width so that its contraction is
defined; ``InstanceNorm`` is standard instance norm, the reference's
``(σ² + ε)²`` divisor behind ``faithful=True``.

The kernels these modules reach: FPS (``fps.cu``) for the seeds, the kNN
(``knn.cu``) or the ball query (``query_ball.cu``) in the grouping and the
EdgeConv graphs, and the attention kernel (``attention.cu``) in the
non-local cell where its gate admits the map.  Every module's ``impl``
('auto', or 'torch' for the plain versions) reaches them all.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from dispu_tpu_torch.nn.attention import (PointNonLocalCell, SampleWeights,
                                          adaptive_sampling)
from dispu_tpu_torch.nn.edgeconv import (EdgeConv, FeatureExtractorGCN,
                                         edge_feature)
from dispu_tpu_torch.nn.layers import PointConv, PointMLP, WeightNetHidden
from dispu_tpu_torch.ops.geometry import gen_grid
from dispu_tpu_torch.ops.grouping import grouping
from dispu_tpu_torch.ops.sampling import farthest_point_sample, gather_point

#: the ball radius where a module's ``radius`` is None
DEFAULT_RADIUS = 0.2
#: the channels of the noise ``use_noise`` appends
NOISE_CHANNELS = 16


def _fps_with_features(npoint: int, xyz: torch.Tensor,
                       feature: torch.Tensor, impl: str = "auto"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FPS seeds of ``xyz`` and the features at them."""
    idx = farthest_point_sample(npoint, xyz.detach(), impl=impl)
    return gather_point(xyz, idx), gather_point(feature, idx)


def _radius(radius: Optional[float]) -> float:
    return DEFAULT_RADIUS if radius is None else radius


def _seeds(module, xyz, feature):
    """(new_xyz, new_feature): the input itself where it already has
    ``npoint`` points, else its FPS seeds."""
    if feature.shape[1] == module.npoint:
        return xyz, feature
    return _fps_with_features(module.npoint, xyz, feature, module.impl)


def _noise(feature: torch.Tensor, noise: Optional[torch.Tensor],
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """``feature`` with the 16 noise channels appended: ``noise`` where
    given, else standard normal draws from ``generator``."""
    shape = feature.shape[:-1] + (NOISE_CHANNELS,)
    if noise is None:
        noise = torch.randn(shape, generator=generator,
                            device=feature.device, dtype=feature.dtype)
    elif tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)}, expected "
                         f"{tuple(shape)}")
    return torch.cat([feature, noise.to(feature.dtype)], dim=-1)


# --------------------------------------------------------------------------
# attention offsets
# --------------------------------------------------------------------------


class SampleOffset(nn.Module):
    """Neighbourhood attention, max-pooled, then an MLP to ``mlps[-1]``
    channels squashed into ±``offset_range``: the xyz re-centred on the
    first neighbour before the features, QKV at bottleneck max(32, c //
    2) as in :class:`SampleWeights`.  new_point (b, np, ns, in_features),
    grouped_xyz (b, np, ns, 3) → (b, np, mlps[-1])."""

    def __init__(self, in_features: int, mlps: Sequence[int],
                 use_bn: bool = True, bn_momentum: float = 0.95,
                 scaled: bool = True, offset_range: float = 0.5):
        super().__init__()
        bc = max(32, in_features // 2)
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        self.bottleneck, self.scaled = bc, scaled
        self.offset_range = offset_range
        self.conv_kv_ds = PointConv(3 + in_features, 2 * bc,
                                    activation=None, **kw)
        self.conv_query_ds = PointConv(3 + in_features, bc, activation=None,
                                       **kw)
        self.mlp2 = PointMLP(bc, tuple(mlps), last_activation=None, **kw)

    def forward(self, new_point: torch.Tensor,
                grouped_xyz: torch.Tensor) -> torch.Tensor:
        bc = self.bottleneck
        normalized = grouped_xyz - grouped_xyz[:, :, :1, :]
        x = torch.cat([normalized, new_point], dim=-1)
        kv = self.conv_kv_ds(x)
        q = self.conv_query_ds(x)
        attn = torch.einsum("bnsc,bntc->bnst", q, kv[..., :bc])
        if self.scaled:
            attn = attn / math.sqrt(bc)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bnst,bntc->bnsc", attn, kv[..., bc:])
        out = self.mlp2(torch.amax(out, dim=-2))
        r = self.offset_range
        return torch.sigmoid(out) * (2.0 * r) - r


# --------------------------------------------------------------------------
# set abstraction / downscale family
# --------------------------------------------------------------------------


def _local_cell(owner, new_point, grouped_xyz, feature, new_feature):
    """The ASNL local cell of :class:`PointASNLSetAbstraction` and
    :class:`PointDownscale3_1`: the skip over the max-pooled edge points,
    the edge MLP, a ``weight_net`` matmul pooling over the neighbours,
    ``after_conv``, the optional non-local term, and ``aggregation``, on
    the parameters :func:`_add_local_cell` registered on ``owner``.
    Returns (b, npoint, mlp[-1])."""
    b = new_point.shape[0]
    if owner.use_nonlocal:
        nl = owner.non_local(feature, new_feature[:, None, :, :])[:, 0]
    skip = owner.skip(torch.amax(new_point, dim=2))
    y = new_point
    for i in range(len(owner.mlp) - 1):
        y = getattr(owner, f"conv{i}")(y)
    w = owner.weight_net(grouped_xyz)
    y = torch.einsum("bnkc,bnkt->bnct", y, w).reshape(b, owner.npoint, -1)
    y = owner.after_conv(y) + skip
    if owner.use_nonlocal:
        y = y + nl
    return owner.aggregation(y)


def _add_local_cell(owner, c: int, query_features: int, weight_units: int,
                    kw: dict) -> None:
    """Register the local cell's parameters on ``owner`` (input width
    ``c``, edge points of 3 + 3 + c channels, a ``weight_units``-wide
    weight net)."""
    out_c = owner.mlp[-1]
    width = 6 + c
    if owner.use_nonlocal:
        owner.non_local = PointNonLocalCell(
            c, query_features, max(32, c // 2), out_c, impl=owner.impl,
            **kw)
    owner.skip = PointConv(width, out_c, **kw)
    for i, ch in enumerate(owner.mlp[:-1]):
        owner.add_module(f"conv{i}", PointConv(width, ch, **kw))
        width = ch
    owner.weight_net = WeightNetHidden(3, (weight_units,),
                                       bn_momentum=kw["bn_momentum"])
    owner.after_conv = PointConv(width * weight_units, out_c, **kw)
    owner.aggregation = PointConv(out_c, out_c, **kw)


class PointASNLSetAbstraction(nn.Module):
    """ASNL set abstraction: FPS to ``npoint`` seeds (none where the cloud
    already has that many), kNN or ball grouping, the seeds re-positioned
    by adaptive sampling (``SampleWeights`` over the first ``as_neighbor``
    neighbours), then the local cell, the optional non-local cell and the
    fusion conv.  The reference's undefined ``nl_channel`` is ``mlp[-1]``.

    The input cloud has ``in_points`` points.  Where that is ``npoint``
    there is no FPS and no adaptive sampling, so no ``SampleWeights``,
    and the non-local queries are c wide, not 3 + c.  xyz (b, in_points,
    3), feature (b, in_points, in_features) → (new_xyz (b, npoint, 3),
    (b, npoint, mlp[-1]))."""

    def __init__(self, in_features: int, npoint: int, nsample: int,
                 mlp: Sequence[int], in_points: int, use_bn: bool = True,
                 bn_momentum: float = 0.95, use_knn: bool = True,
                 radius: Optional[float] = None, as_neighbor: int = 8,
                 use_nonlocal: bool = True, impl: str = "auto"):
        super().__init__()
        self.npoint, self.nsample, self.mlp = npoint, nsample, tuple(mlp)
        self.use_knn, self.radius = use_knn, radius
        self.as_neighbor, self.use_nonlocal = as_neighbor, use_nonlocal
        self.in_points, self.impl = in_points, impl
        same_size = in_points == npoint
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        c = in_features
        grouped = 3 + c  # the grouping prepends the neighbour xyz
        if not same_size:
            self.SampleWeights = SampleWeights(grouped, (32, 1 + grouped),
                                               **kw)
        _add_local_cell(self, c, c if same_size else grouped, 32, kw)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if feature.shape[1] != self.in_points:
            raise ValueError(f"built for {self.in_points} points, called on "
                             f"{feature.shape[1]}")
        new_xyz, new_feature = _seeds(self, xyz, feature)
        grouped_xyz, new_point, _ = grouping(
            feature, self.nsample, xyz, new_xyz, use_knn=self.use_knn,
            radius=_radius(self.radius), impl=self.impl)
        if self.in_points != self.npoint:
            new_xyz, new_feature = adaptive_sampling(
                self.SampleWeights, grouped_xyz, new_point, self.as_neighbor)
        grouped_xyz = grouped_xyz - new_xyz[:, :, None, :]
        new_point = torch.cat([grouped_xyz, new_point], dim=-1)
        return new_xyz, _local_cell(self, new_point, grouped_xyz, feature,
                                    new_feature)


class _Downscale(nn.Module):
    """What the downscalers share: FPS seeds (or the input where it has
    ``npoint`` points) and their grouping."""

    def __init__(self, npoint, nsample, use_knn, radius, impl):
        super().__init__()
        self.npoint, self.nsample = npoint, nsample
        self.use_knn, self.radius, self.impl = use_knn, radius, impl

    def _group(self, xyz, feature):
        new_xyz, _ = _seeds(self, xyz, feature)
        grouped_xyz, grouped_feature, _ = grouping(
            feature, self.nsample, xyz, new_xyz, use_knn=self.use_knn,
            radius=_radius(self.radius), impl=self.impl)
        return new_xyz, grouped_xyz, grouped_feature


class PointDownscale(_Downscale):
    """FPS seeds and an attention-weighted xyz re-positioning: a
    single-channel ``SampleWeights`` head over the first ``as_neighbor``
    neighbours and the weighted xyz sum as the 'offset' (an absolute
    position, the reference's name notwithstanding).  → (new_xyz,
    new_offset), both (b, npoint, 3)."""

    def __init__(self, in_features: int, npoint: int, nsample: int,
                 use_bn: bool = True, bn_momentum: float = 0.95,
                 use_knn: bool = True, radius: Optional[float] = None,
                 as_neighbor: int = 8, impl: str = "auto"):
        super().__init__(npoint, nsample, use_knn, radius, impl)
        self.as_neighbor = as_neighbor
        self.SampleWeights = SampleWeights(3 + in_features, (32, 1),
                                           use_bn=use_bn,
                                           bn_momentum=bn_momentum)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor):
        new_xyz, group_xyz, group_feature = self._group(xyz, feature)
        sg_xyz = group_xyz[:, :, :self.as_neighbor, :]
        w = self.SampleWeights(group_feature[:, :, :self.as_neighbor, :],
                               sg_xyz)
        return new_xyz, torch.sum(sg_xyz * w, dim=2)


class PointDownscale2(_Downscale):
    """FPS seeds and a ``SampleOffset`` head: a bounded per-seed 3-d
    offset.  → (new_xyz, offset), both (b, npoint, 3)."""

    def __init__(self, in_features: int, npoint: int, nsample: int,
                 use_bn: bool = True, bn_momentum: float = 0.95,
                 use_knn: bool = True, radius: Optional[float] = None,
                 as_neighbor: int = 8, impl: str = "auto"):
        super().__init__(npoint, nsample, use_knn, radius, impl)
        self.as_neighbor = as_neighbor
        self.SampleOffset = SampleOffset(3 + in_features, (32, 3),
                                         use_bn=use_bn,
                                         bn_momentum=bn_momentum)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor):
        new_xyz, group_xyz, group_feature = self._group(xyz, feature)
        a = self.as_neighbor
        return new_xyz, self.SampleOffset(group_feature[:, :, :a, :],
                                          group_xyz[:, :, :a, :])


class PointDownscale3(_Downscale):
    """FPS seeds, attention feature pooling (``SampleWeights`` with a [C,
    C] head over the first ``as_neighbor`` neighbours, C = 3 + c), the
    optional 16 noise channels, an MLP [C, 64, 3] and the optional ±0.5
    sigmoid squash.  → (new_xyz, (b, npoint, 3)).

    With ``use_noise`` the forward takes the (b, npoint, 16) ``noise``, or
    draws it standard normal from ``generator``."""

    def __init__(self, in_features: int, npoint: int, nsample: int,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 use_knn: bool = True, radius: Optional[float] = None,
                 as_neighbor: int = 8, use_noise: bool = False,
                 use_sm: bool = True, impl: str = "auto"):
        super().__init__(npoint, nsample, use_knn, radius, impl)
        self.as_neighbor, self.use_noise, self.use_sm = (as_neighbor,
                                                         use_noise, use_sm)
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        c = 3 + in_features
        self.SampleWeights = SampleWeights(c, (c, c), **kw)
        self.mlp2 = PointMLP(c + NOISE_CHANNELS * use_noise, (c, 64, 3),
                             last_activation=None, **kw)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        new_xyz, group_xyz, group_feature = self._group(xyz, feature)
        a = self.as_neighbor
        sg_pts = group_feature[:, :, :a, :]
        w = self.SampleWeights(sg_pts, group_xyz[:, :, :a, :])
        new_feature = torch.sum(sg_pts * w, dim=2)
        if self.use_noise:
            new_feature = _noise(new_feature, noise, generator)
        out = self.mlp2(new_feature)
        if self.use_sm:
            out = torch.sigmoid(out) - 0.5
        return new_xyz, out


class PointDownscale3_1(nn.Module):
    """The ASNL body (the local cell with an ``nsample``-wide weight net,
    the skip, the optional non-local cell, the fusion conv) without
    adaptive sampling, then a 128 → 64 → 3 coordinate MLP and the optional
    sigmoid squash.  → (new_xyz, (b, npoint, 3))."""

    def __init__(self, in_features: int, npoint: int, nsample: int,
                 mlp: Sequence[int], use_bn: bool = False,
                 bn_momentum: float = 0.95, use_knn: bool = True,
                 radius: Optional[float] = None, use_nonlocal: bool = True,
                 use_sm: bool = True, impl: str = "auto"):
        super().__init__()
        self.npoint, self.nsample, self.mlp = npoint, nsample, tuple(mlp)
        self.use_knn, self.radius = use_knn, radius
        self.use_nonlocal, self.use_sm, self.impl = use_nonlocal, use_sm, impl
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        _add_local_cell(self, in_features, in_features, nsample, kw)
        self.coord = PointMLP(self.mlp[-1], (128, 64, 3),
                              last_activation=None)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor):
        new_xyz, new_feature = _seeds(self, xyz, feature)
        grouped_xyz, new_point, _ = grouping(
            feature, self.nsample, xyz, new_xyz, use_knn=self.use_knn,
            radius=_radius(self.radius), impl=self.impl)
        grouped_xyz = grouped_xyz - new_xyz[:, :, None, :]
        new_point = torch.cat([grouped_xyz, new_point], dim=-1)
        y = _local_cell(self, new_point, grouped_xyz, feature, new_feature)
        coord = self.coord(y)
        if self.use_sm:
            coord = torch.sigmoid(coord) - 0.5
        return new_xyz, coord


class PointDownscale4(_Downscale):
    """FPS seeds, a PointNet-style neighbourhood (two per-edge convs [c,
    c], the second linear), max-pooled, the optional noise channels, an
    MLP [c, 64, 3] and the optional sigmoid squash.  ``nsample`` defaults
    to 32, the value the reference's body sets whatever it is passed.
    With ``use_noise``, ``noise`` / ``generator`` as in
    :class:`PointDownscale3`."""

    def __init__(self, in_features: int, npoint: int, nsample: int = 32,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 use_knn: bool = True, radius: Optional[float] = None,
                 use_noise: bool = False, use_sm: bool = True,
                 impl: str = "auto"):
        super().__init__(npoint, nsample, use_knn, radius, impl)
        self.use_noise, self.use_sm = use_noise, use_sm
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        c = in_features
        self.mlp1_2_0 = PointConv(3 + c, c, **kw)
        self.mlp1_2_1 = PointConv(c, c, activation=None)
        self.mlp2 = PointMLP(c + NOISE_CHANNELS * use_noise, (c, 64, 3),
                             last_activation=None, **kw)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        new_xyz, _, group_feature = self._group(xyz, feature)
        y = self.mlp1_2_1(self.mlp1_2_0(group_feature))
        new_feature = torch.amax(y, dim=2)
        if self.use_noise:
            new_feature = _noise(new_feature, noise, generator)
        out = self.mlp2(new_feature)
        if self.use_sm:
            out = torch.sigmoid(out) - 0.5
        return new_xyz, out


class PointShuffleV1(nn.Module):
    """The refiner's first iteration: a 16-neighbour grouping, a
    ``SampleWeights`` head over the first ``nsample`` neighbours and the
    weighted feature sum.  The head is sized from the feature channels (C
    = 3 + c), where the reference's, sized from the xyz channels, only
    fits 3-channel features.  → (b, n, 3 + c)."""

    def __init__(self, in_features: int, nsample: int, use_bn: bool = True,
                 bn_momentum: float = 0.95, use_knn: bool = True,
                 radius: Optional[float] = None, impl: str = "auto"):
        super().__init__()
        self.nsample, self.use_knn, self.radius = nsample, use_knn, radius
        self.impl = impl
        c = 3 + in_features
        self.SampleWeights = SampleWeights(c, (c, c), use_bn=use_bn,
                                           bn_momentum=bn_momentum)

    def forward(self, xyz: torch.Tensor, feature: torch.Tensor
                ) -> torch.Tensor:
        group_xyz, group_feature, _ = grouping(
            feature, 16, xyz, xyz, use_knn=self.use_knn,
            radius=_radius(self.radius), impl=self.impl)
        sg_pts = group_feature[:, :, :self.nsample, :]
        w = self.SampleWeights(sg_pts, group_xyz[:, :, :self.nsample, :])
        return torch.sum(sg_pts * w, dim=2)


# --------------------------------------------------------------------------
# shuffle-based upsampling family
# --------------------------------------------------------------------------


def point_shuffler(inputs: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Channel → point shuffle: (b, n, 1, c) → (b, n·scale, 1,
    c/scale), the channel axis read as (c/scale, scale) and the scale
    factor moved onto the point axis."""
    b, n, _, c = inputs.shape
    out = inputs.reshape(b, n, 1, c // scale, scale).permute(0, 1, 4, 3, 2)
    return out.reshape(b, n * scale, 1, c // scale)


def shuffle_down(inputs: torch.Tensor, scale: int) -> torch.Tensor:
    """The reference's NCHW pixel-unshuffle, (b, c, h, w) → (b, c·s², h/s,
    w/s).  Its channel order is not ``F.pixel_unshuffle``'s: the two
    sub-pixel axes come out swapped."""
    b, c, ih, iw = inputs.shape
    oh, ow = ih // scale, iw // scale
    out = inputs.reshape(b, c, oh, scale, ow, scale)
    return out.permute(0, 1, 5, 3, 2, 4).reshape(b, -1, oh, ow)


def shuffle_up(inputs: torch.Tensor, scale: int) -> torch.Tensor:
    """The reference's NCHW pixel-shuffle, (b, c, h, w) → (b, c/s², h·s,
    w·s), the inverse of :func:`shuffle_down`; not ``F.pixel_shuffle``
    (its sub-pixel axes and the spatial ones interleave otherwise)."""
    b, c, ih, iw = inputs.shape
    oc = c // (scale ** 2)
    out = inputs.reshape(b, oc, scale, scale, ih, iw)
    return out.permute(0, 1, 4, 3, 5, 2).reshape(b, oc, ih * scale,
                                                 iw * scale)


class UpShuffleLayer(nn.Module):
    """An r-fold channel expansion (``up_shuffle_layer1``) and a point
    shuffle: ``variant`` 1 reads the r·c channels (c, r)-major
    (``up_shuffle_layer``), 2 (r, c)-major (``up_shuffle_layer2``).
    (b, n, c) → (b, n·r, c)."""

    def __init__(self, in_features: int, up_ratio: int = 4,
                 variant: int = 1):
        super().__init__()
        if variant not in (1, 2):
            raise ValueError(f"unknown variant {variant!r}")
        self.up_ratio, self.variant = up_ratio, variant
        self.up_shuffle_layer1 = PointConv(in_features,
                                           up_ratio * in_features)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        b, n, c = feature.shape
        r = self.up_ratio
        out = self.up_shuffle_layer1(feature)
        if self.variant == 1:
            out = out.reshape(b, n, c, r).transpose(2, 3)
        else:
            out = out.reshape(b, n, r, c)
        return out.reshape(b, n * r, c)


class UpShuffleLayer3(nn.Module):
    """A conv (``up_shuffle_layer0``), an :class:`EdgeConv` expansion to
    r·c channels (``up_shuffle_layer1``) and the (r, c)-major point
    shuffle.  (b, n, c) → (b, n·r, c)."""

    def __init__(self, in_features: int, up_ratio: int = 4, k: int = 16,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 impl: str = "auto"):
        super().__init__()
        self.up_ratio = up_ratio
        c = in_features
        self.up_shuffle_layer0 = PointConv(c, c, use_bn=use_bn,
                                           bn_momentum=bn_momentum)
        self.up_shuffle_layer1 = EdgeConv(c, up_ratio * c, k=k,
                                          use_bn=use_bn,
                                          bn_momentum=bn_momentum, impl=impl)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        b, n, c = feature.shape
        up = self.up_shuffle_layer1(self.up_shuffle_layer0(feature))
        return up.reshape(b, n * self.up_ratio, c)


class UpShuffleLayer4(nn.Module):
    """Edge-feature fold and expand: the kNN edges (b, n, k, 2c); each
    window of r neighbours folded by a dense to r·2c channels
    (``up_shuffle_layer0``, the reference's [1, r] stride-r conv), the
    channels re-split 2c-major back onto the neighbour axis; the original
    and folded stacks joined to 2k neighbours and reduced by a dense over
    the whole window (``up_shuffle_layer1``, the [1, 2k] conv) to r·c
    channels, read as r points of c.  (b, n, c) → (b, n·r, c)."""

    def __init__(self, in_features: int, up_ratio: int = 4, k: int = 16,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 impl: str = "auto"):
        super().__init__()
        if k % up_ratio:
            raise ValueError(f"k={k} is not a multiple of "
                             f"up_ratio={up_ratio}")
        self.up_ratio, self.k, self.impl = up_ratio, k, impl
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        cc = 2 * in_features
        self.up_shuffle_layer0 = PointConv(up_ratio * cc, up_ratio * cc, **kw)
        self.up_shuffle_layer1 = PointConv(2 * k * cc, cc // 2 * up_ratio,
                                           **kw)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        b, n, _ = feature.shape
        r, k = self.up_ratio, self.k
        edges, _ = edge_feature(feature, k, impl=self.impl)  # (b, n, k, cc)
        cc = edges.shape[-1]
        tmp = self.up_shuffle_layer0(edges.reshape(b, n, k // r, r * cc))
        tmp = tmp.transpose(2, 3).reshape(b, n, cc, k).transpose(2, 3)
        merged = torch.cat([edges, tmp], dim=2).reshape(b, n, 2 * k * cc)
        out = self.up_shuffle_layer1(merged)
        return out.reshape(b, n * r, cc // 2)


class UpShuffleLayer5(nn.Module):
    """A 2× edge upsampler gated by the xyz: the edges of the features
    (b, n, k, 2c) and of ``pc`` on the same graph; the gate
    ``softmax_k(w(w_feat(edges)·w_pc(edge_pc)))``; pairs of neighbours
    folded to 2·2c channels, re-split, gated; joined with the edges and
    reduced over the whole window to 2·2c channels, read as 2 points of
    2c.  pc (b, n, pc_features), feature (b, n, c) → (b, 2n, 2c)."""

    def __init__(self, in_features: int, k: int = 16, use_bn: bool = False,
                 bn_momentum: float = 0.95, pc_features: int = 3,
                 impl: str = "auto"):
        super().__init__()
        if k % 2:
            raise ValueError(f"k={k} is odd")
        self.k, self.impl = k, impl
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        cc = 2 * in_features
        self.w_feat = PointConv(cc, cc, **kw)
        self.w_pc = PointConv(2 * pc_features, cc, **kw)
        self.w = PointConv(cc, cc, **kw)
        self.up_shuffle_layer0 = PointConv(2 * cc, 2 * cc, **kw)
        self.up_shuffle_layer1 = PointConv(2 * k * cc, 2 * cc, **kw)

    def forward(self, pc: torch.Tensor, feature: torch.Tensor
                ) -> torch.Tensor:
        b, n, _ = feature.shape
        k = self.k
        edges, idx = edge_feature(feature, k, impl=self.impl)
        edge_pc, _ = edge_feature(pc, k, idx=idx, impl=self.impl)
        cc = edges.shape[-1]
        w = self.w(self.w_feat(edges) * self.w_pc(edge_pc))
        w = torch.softmax(w, dim=-2)
        tmp = self.up_shuffle_layer0(edges.reshape(b, n, k // 2, 2 * cc))
        tmp = tmp.transpose(2, 3).reshape(b, n, cc, k).transpose(2, 3) * w
        merged = torch.cat([edges, tmp], dim=2).reshape(b, n, 2 * k * cc)
        return self.up_shuffle_layer1(merged).reshape(b, 2 * n, cc)


class DuplicateUpEdge(nn.Module):
    """The features tiled r times (r-major), each copy with its 2-d grid
    code, then EdgeConv(256) → EdgeConv(128) on feature-space kNN graphs
    of the tiled set (``shuffle_layer_0``, ``shuffle_layer_1``).  (b, n,
    c) → (b, n·r, 128)."""

    def __init__(self, in_features: int, up_ratio: int = 4, k: int = 16,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 impl: str = "auto"):
        super().__init__()
        self.up_ratio = up_ratio
        kw = dict(k=k, use_bn=use_bn, bn_momentum=bn_momentum, impl=impl)
        self.shuffle_layer_0 = EdgeConv(in_features + 2, 256, **kw)
        self.shuffle_layer_1 = EdgeConv(256, 128, **kw)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        b, n, _ = feature.shape
        r = self.up_ratio
        grid = gen_grid(r).to(device=feature.device, dtype=feature.dtype)
        grid = torch.repeat_interleave(grid, n, dim=0).expand(b, -1, -1)
        net = torch.cat([feature.repeat(1, r, 1), grid], dim=-1)
        return self.shuffle_layer_1(self.shuffle_layer_0(net))


class DuplicateUp2(nn.Module):
    """Duplication with a patch-wide grid code: ``gen_grid(patch_num ·
    up_ratio)`` cut to the n·r output points (one code a point, where
    ``DuplicateUp`` tiles r codes), then conv 256 → conv 128 (``conv1``,
    ``conv2``).  (b, n, c) → (b, n·r, 128)."""

    def __init__(self, in_features: int, up_ratio: int = 4,
                 patch_num: int = 256):
        super().__init__()
        self.up_ratio, self.patch_num = up_ratio, patch_num
        self.conv1 = PointConv(in_features + 2, 256)
        self.conv2 = PointConv(256, 128)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        b, n, _ = feature.shape
        r = self.up_ratio
        grid = gen_grid(self.patch_num * r)[:n * r]
        if grid.shape[0] != n * r:
            raise ValueError(f"{n} points exceed patch_num={self.patch_num}")
        grid = grid.to(device=feature.device, dtype=feature.dtype)
        net = torch.cat([feature.repeat(1, r, 1), grid.expand(b, -1, -1)],
                        dim=-1)
        return self.conv2(self.conv1(net))


class PointUpscale(nn.Module):
    """:class:`UpShuffleLayer3` at ``up_ratio = npoint // in_points`` (the
    reference passes the features in its xyz slot, whose path is dead
    code), then a c → 128 → 64 coordinate MLP (``coord``, ReLU
    throughout) and a linear head to 3 (``coord_layer3``).  The input
    has ``in_points`` points.  (b, in_points, c) → (b, npoint', 3) with
    npoint' = in_points · up_ratio."""

    def __init__(self, in_features: int, npoint: int, in_points: int,
                 k: int = 16, use_bn: bool = False, bn_momentum: float = 0.95,
                 impl: str = "auto"):
        super().__init__()
        self.in_points = in_points
        c = in_features
        self.up_shuffle_layer3 = UpShuffleLayer3(
            c, up_ratio=npoint // in_points, k=k, use_bn=use_bn,
            bn_momentum=bn_momentum, impl=impl)
        self.coord = PointMLP(c, (c, 128, 64), last_activation=torch.relu)
        self.coord_layer3 = PointConv(64, 3, activation=None)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        if feature.shape[1] != self.in_points:
            raise ValueError(f"built for {self.in_points} points, called on "
                             f"{feature.shape[1]}")
        return self.coord_layer3(self.coord(self.up_shuffle_layer3(feature)))


# --------------------------------------------------------------------------
# extractor aliases + misc units
# --------------------------------------------------------------------------


def feature_extraction_down(in_features: int,
                            name: str = "feature_extraction_down",
                            **kwargs) -> PointMLP:
    """Two pointwise lifts, conv(32) → conv(64), ReLU both (no
    downsampling despite the name).  The module's ``name`` is the flax
    scope name, under which a parent registers it."""
    mod = PointMLP(in_features, (32, 64), last_activation=torch.relu,
                   **kwargs)
    mod.name = name
    return mod


def feature_extraction_up(in_features: int = 3, growth_rate: int = 24,
                          use_bn: bool = False,
                          name: str = "feature_extraction_up",
                          **kwargs) -> FeatureExtractorGCN:
    """The 4-block dense EdgeConv extractor, ``FeatureExtractorGCN(
    dense_block=4)`` channel for channel (480 channels at growth 24);
    ``name`` as in :func:`feature_extraction_down`."""
    mod = FeatureExtractorGCN(in_features, growth_rate, dense_block=4,
                              use_bn=use_bn, **kwargs)
    mod.name = name
    return mod


def feature_extraction_up2(in_features: int = 3, growth_rate: int = 24,
                           name: str = "feature_extraction_up2",
                           **kwargs) -> FeatureExtractorGCN:
    """:func:`feature_extraction_up` with ``use_bn`` False."""
    return feature_extraction_up(in_features, growth_rate, use_bn=False,
                                 name=name, **kwargs)


class WeightLearningUnit(nn.Module):
    """A grid-conditioned weight bank contracted against the inputs: the
    1-d code (linspace(−0.2, 0.2, r), r) through three linear convs to
    ``dim``, ``dim·r`` and back to ``dim`` channels (the reference's
    contraction of ``dim`` against ``dim·r`` channels is undefined; the
    projection back makes it defined), contracted with the inputs to (b,
    n, 1, n·r) scores.  inputs (b, n, 1, dim)."""

    def __init__(self, in_features: int, up_ratio: int = 4):
        super().__init__()
        dim, r = in_features, up_ratio
        self.up_ratio = r
        self.conv_1 = PointConv(2, dim, activation=None)
        self.conv_2 = PointConv(dim, dim * r, activation=None)
        self.conv_3 = PointConv(dim * r, dim, activation=None)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        b, n, _, dim = inputs.shape
        r = self.up_ratio
        grid = torch.linspace(-0.2, 0.2, r, dtype=inputs.dtype,
                              device=inputs.device)[:, None]
        code = torch.cat([grid, torch.full_like(grid, float(r))], dim=1)
        w = code[None, None].expand(b, n, r, 2)
        w = self.conv_3(self.conv_2(self.conv_1(w)))
        s = torch.einsum("bqc,bkc->bqk", inputs.reshape(b, n, dim),
                         w.reshape(b, n * r, dim))
        return s[:, :, None, :]


class CoordinateReconstructionUnit(nn.Module):
    """conv(64, ReLU) → conv(3, linear) (``fc_layer1``, ``fc_layer2``) over
    (b, n, 1, c), the singleton axis squeezed: → (b, n, 3)."""

    def __init__(self, in_features: int):
        super().__init__()
        self.fc_layer1 = PointConv(in_features, 64)
        self.fc_layer2 = PointConv(64, 3, activation=None)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if inputs.shape[2] != 1:
            raise ValueError(f"axis 2 has {inputs.shape[2]} entries, not 1")
        return self.fc_layer2(self.fc_layer1(inputs))[:, :, 0]


class InstanceNorm(nn.Module):
    """Instance normalisation over every axis between the batch and the
    channels, with a learned ``shift`` (0 at init) and ``scale`` (1):
    ``scale·(x − μ)/√(σ² + ε) + shift``.  ``faithful=True`` divides by
    ``(σ² + ε)²`` instead, as the reference does."""

    def __init__(self, features: int, epsilon: float = 1e-3,
                 faithful: bool = False):
        super().__init__()
        self.epsilon, self.faithful = epsilon, faithful
        self.shift = nn.Parameter(torch.zeros(features))
        self.scale = nn.Parameter(torch.ones(features))

    def reset_own(self) -> None:
        """``shift`` to 0 and ``scale`` to 1 (:func:`~dispu_tpu_torch.nn.
        layers.init_weights`)."""
        with torch.no_grad():
            self.shift.zero_()
            self.scale.fill_(1.0)

    def forward(self, net: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, net.dim() - 1))
        mu = torch.mean(net, dim=axes, keepdim=True)
        var = torch.var(net, dim=axes, keepdim=True, correction=0)
        if self.faithful:
            normalized = (net - mu) / torch.square(var + self.epsilon)
        else:
            normalized = (net - mu) * torch.rsqrt(var + self.epsilon)
        return self.scale * normalized + self.shift
