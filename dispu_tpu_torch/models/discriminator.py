"""PointNet++-MSG patch critic of the GAN variant (counterpart of
``models/discriminator.py``).

FPS seeds on the ground-truth cloud; at each of three scales both clouds'
seed neighbourhoods (kNN at k 8/16/24, or ball queries), centred on the
seeds, run through shared leaky-ReLU MLPs, and each half is max-pooled on
its own: paired real/fake features per seed in one pass.  A linear head
maps them to patch values; ``[:, :, 0]`` is the real (gt) value and
``[:, :, 1]`` the fake (pred) one.  Submodule names are the flax scope
names, so a flax tree converts by path (``convert.from_flax_variables``).

The parameter-free geometry (seeds, neighbour indices, gathers) is
factored out (:func:`paired_neighborhoods_with_pred_indices`), so that a
GAN step computes it once for the critic's update and the generator's.
With ``DiscriminatorConfig.fused_grouping`` (and ``knn``) the
neighbourhoods come from the ``knn_group`` kernel at clouds of at most
2048 points, as the JAX package's gate admits its Pallas kernel; its
indices and rows are those of the composed kNN and gather.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from dispu_tpu_torch.config import DiscriminatorConfig
from dispu_tpu_torch.kernels import knn_group as _knn_group
from dispu_tpu_torch.nn.layers import PointConv, init_weights
from dispu_tpu_torch.ops.grouping import group_point, query_ball_point
from dispu_tpu_torch.ops.knn import knn_indices
from dispu_tpu_torch.ops.sampling import farthest_point_sample, gather_point


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``leaky_relu`` at slope 0.2: ``where(x >= 0, x, 0.2·x)``,
    whose gradient at 0 is 1 (``F.leaky_relu``'s is the slope)."""
    return torch.where(x >= 0, x, 0.2 * x)


def paired_neighborhoods_with_pred_indices(cfg: DiscriminatorConfig,
                                           gt: torch.Tensor,
                                           pred: torch.Tensor,
                                           impl: str = "auto"):
    """The critic's geometry: ``((seeds, [(grouped_gt, grouped_pred), …]),
    pred_idx)`` — FPS seeds on ``gt`` (b, n/``downsample_ratio``, 3), per
    scale both clouds' seed-centred neighbourhoods (b, np, nsample, 3), and
    per scale the pred neighbour indices, so that :func:`regather_pred`
    can gather again from a differentiable ``pred``."""
    npoint = gt.shape[1] // cfg.downsample_ratio
    seeds = gather_point(gt, farthest_point_sample(npoint, gt.detach(),
                                                   impl=impl))
    fused = cfg.fused_grouping and cfg.knn and gt.shape[1] <= 2048

    def neighborhood(cloud, nsample, radius):
        if fused:
            cloud = cloud.contiguous()
            _, idx, _, nbrs = _knn_group.knn_group(
                nsample, cloud, seeds.contiguous(), cloud, with_xyz=False,
                impl=impl)
            return nbrs - seeds[:, :, None, :], idx
        if cfg.knn:
            idx = knn_indices(nsample, cloud, seeds, impl=impl)
        else:
            idx = query_ball_point(radius, nsample, cloud, seeds,
                                   impl=impl)[0]
        return group_point(cloud, idx) - seeds[:, :, None, :], idx

    per_scale, pred_idx = [], []
    for radius, nsample in zip(cfg.radius_list, cfg.nsample_list):
        g_gt, _ = neighborhood(gt, nsample, radius)
        g_pred, idx_p = neighborhood(pred, nsample, radius)
        per_scale.append((g_gt, g_pred))
        pred_idx.append(idx_p)
    return (seeds, per_scale), pred_idx


def paired_neighborhoods(cfg: DiscriminatorConfig, gt: torch.Tensor,
                         pred: torch.Tensor, impl: str = "auto"):
    """``(seeds, [(grouped_gt, grouped_pred), …])``; see
    :func:`paired_neighborhoods_with_pred_indices`."""
    return paired_neighborhoods_with_pred_indices(cfg, gt, pred, impl)[0]


def regather_pred(groups, pred_idx, pred: torch.Tensor):
    """``groups`` with the pred neighbourhoods gathered again from
    ``pred`` at the same indices (the gt halves reused): the same values,
    and differentiable in ``pred``."""
    seeds, per_scale = groups
    return seeds, [(g_gt, group_point(pred, idx) - seeds[:, :, None, :])
                   for (g_gt, _), idx in zip(per_scale, pred_idx)]


class PairedMSGModule(nn.Module):
    """Multi-scale paired (gt, pred) set abstraction around shared seeds.

    ``fused=False``: each scale's output is the (b, np, 2, c) stack of the
    separately max-pooled gt and pred halves.  ``fused=True`` (msg2): a
    fusion layer per scale maps the pair to one (b, np, c) feature."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(),
                 fused: bool = False, impl: str = "auto"):
        super().__init__()
        self.cfg, self.fused, self.impl = cfg, fused, impl
        for i, mlps in enumerate(cfg.mlp_lists):
            width = 3
            for j, c in enumerate(mlps):
                self.add_module(f"conv{i}_{j}",
                                PointConv(width, c, activation=leaky_relu))
                width = c
            if fused:
                self.add_module(f"conv_fusion_{i}", PointConv(
                    2 * width, width, activation=leaky_relu))
        self.out_features = sum(m[-1] for m in cfg.mlp_lists)

    def forward(self, gt: torch.Tensor, pred: torch.Tensor, groups=None):
        cfg = self.cfg
        if groups is None:
            groups = paired_neighborhoods(cfg, gt, pred, self.impl)
        seeds, per_scale = groups
        scale_feats = []
        for i, ((g_gt, g_pred), nsample, mlps) in enumerate(
                zip(per_scale, cfg.nsample_list, cfg.mlp_lists)):
            g = torch.cat([g_gt, g_pred], dim=2)  # (b, np, 2·ns, 3)
            for j in range(len(mlps)):
                g = getattr(self, f"conv{i}_{j}")(g)
            pooled = torch.stack([torch.amax(g[:, :, :nsample], dim=2),
                                  torch.amax(g[:, :, nsample:], dim=2)],
                                 dim=2)  # (b, np, 2, c): [gt, pred]
            if self.fused:
                b, npt, _, c = pooled.shape
                pooled = getattr(self, f"conv_fusion_{i}")(
                    pooled.reshape(b, npt, 2 * c))
            scale_feats.append(pooled)
        return seeds, torch.cat(scale_feats, dim=-1)


class PatchDiscriminator(nn.Module):
    """(pred, gt) → (b, num_seeds, 2, 1) patch values [real, fake].

    ``impl`` routes the FPS, kNN and ball-query kernels of the geometry
    when it is not passed in (see ``dispu_tpu_torch.kernels``).  Weights
    are glorot-uniform with zero biases, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(),
                 impl: str = "auto", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.layer1 = PairedMSGModule(cfg, fused=False, impl=impl)
        self.patch = PointConv(self.layer1.out_features, 1, activation=None)
        init_weights(self, torch.Generator().manual_seed(seed))

    def forward(self, pred: torch.Tensor, gt: torch.Tensor,
                groups=None) -> torch.Tensor:
        _, feats = self.layer1(gt, pred, groups=groups)
        return self.patch(feats)


def split_real_fake(values: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, np, 2, 1) patch values → (d_real, d_fake), each (b, np, 1)."""
    return values[:, :, 0, :], values[:, :, 1, :]
