"""Attention cells (counterpart of ``nn/attention.py``): the refiner's
non-local cell, the neighbourhood weights of adaptive sampling, and the
self-attention unit of the up blocks.

``global_attention`` keeps the JAX package's dispatch rule: the attention
kernel runs where the map is large (nq·nk ≥ 512²) and the widths fit, on
the card here as on the TPU there; elsewhere the f32 composition runs, as
XLA's einsum does in the JAX package.  :class:`SampleWeights` and
:class:`AttentionUnit` take their products with plain einsums, as the
JAX package does outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from dispu_tpu_torch.kernels import IMPLS
from dispu_tpu_torch.kernels.attention import attention, attention_torch
from dispu_tpu_torch.nn.layers import PointConv, PointMLP


def global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, impl: str = "auto") -> torch.Tensor:
    """``softmax(scale·q·kᵀ)·v`` for (b, nq, c), (b, nk, c), (b, nk, cv).

    impl 'auto': the kernel for CUDA tensors when nk ≤ 8192, c ≤ 256,
    cv ≤ 256 and nq·nk ≥ 512² (the JAX package's rule, whose widths the
    kernel takes); the plain f32 version otherwise (always on
    the CPU).  'cuda' forces the kernel.  'torch' runs, where the kernel
    would run, its plain version in the kernel's bf16 numerics.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    b, nq, c = q.shape
    nk, cv = v.shape[1], v.shape[2]
    fits = nk <= 8192 and c <= 256 and cv <= 256
    if impl == "cuda" or (q.is_cuda and fits and nq * nk >= 512 * 512):
        return attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         scale, impl="torch" if impl == "torch" else "cuda")
    return attention_torch(q, k, v, scale)


class PointNonLocalCell(nn.Module):
    """Global QKV attention from query points to the whole cloud: K/V from
    one projection of the dataset features, Q from the queries, scaled
    dot-product softmax, then a ReLU output projection.

    feature (b, nd, c) and new_point (b, np, ns, c) → (b, np, ns, out).
    """

    def __init__(self, in_features: int, query_features: int,
                 bottleneck: int, out_features: int, use_bn: bool = False,
                 bn_momentum: float = 0.95, scaled: bool = True,
                 impl: str = "auto"):
        super().__init__()
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        self.bottleneck, self.scaled, self.impl = bottleneck, scaled, impl
        self.conv_kv = PointConv(in_features, 2 * bottleneck,
                                 activation=None, **kw)
        self.conv_query = PointConv(query_features, bottleneck,
                                    activation=None, **kw)
        self.conv_back_project = PointConv(bottleneck, out_features, **kw)

    def forward(self, feature: torch.Tensor,
                new_point: torch.Tensor) -> torch.Tensor:
        b, np_, ns, _ = new_point.shape
        bc = self.bottleneck
        kv = self.conv_kv(feature)
        q = self.conv_query(new_point).reshape(b, np_ * ns, bc)
        scale = 1.0 / float(bc) ** 0.5 if self.scaled else 1.0
        out = global_attention(q, kv[..., :bc], kv[..., bc:], scale,
                               impl=self.impl)
        return self.conv_back_project(out.reshape(b, np_, ns, bc))


class SampleWeights(nn.Module):
    """Self-attention within each neighbourhood, producing per-neighbour
    weights: the xyz re-centred on the first neighbour before the
    features, QKV projections ``conv_kv_ds`` / ``conv_query_ds`` at
    bottleneck max(32, c // 2), softmax(q·kᵀ / √bottleneck)·v, the MLP
    ``mlp2`` (linear last), then a softmax over the neighbours.

    new_point (b, s, k, in_features), grouped_xyz (b, s, k, 3) → (b, s,
    k, mlps[-1]).
    """

    def __init__(self, in_features: int, mlps: Sequence[int],
                 use_bn: bool = True, bn_momentum: float = 0.95,
                 scaled: bool = True):
        super().__init__()
        bc = max(32, in_features // 2)
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        self.bottleneck, self.scaled = bc, scaled
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
        out = self.mlp2(torch.einsum("bnst,bntc->bnsc", attn, kv[..., bc:]))
        return torch.softmax(out, dim=2)


def adaptive_sampling(sample_weights_module: SampleWeights,
                      group_xyz: torch.Tensor, group_feature: torch.Tensor,
                      num_neighbor: int):
    """Query points re-positioned from their first ``num_neighbor``
    neighbours: the first weight channel sums the xyz, the others the
    features (which must broadcast against them, as in the JAX package).
    Returns (new_xyz (b, s, 3), new_feature (b, s, c))."""
    if num_neighbor == 0:
        return group_xyz[:, :, 0, :], group_feature[:, :, 0, :]
    sg_xyz = group_xyz[:, :, :num_neighbor, :]
    sg_feat = group_feature[:, :, :num_neighbor, :]
    w = sample_weights_module(sg_feat, sg_xyz)
    return (torch.sum(sg_xyz * w[..., :1], dim=2),
            torch.sum(sg_feat * w[..., 1:], dim=2))


class AttentionUnit(nn.Module):
    """SAGAN-style self-attention over all points with a learned residual
    gate: f, g at in_features // 4 and h at in_features (ReLU each),
    softmax(g·fᵀ)·h over the points, ``gamma``·o + x.  ``gamma`` (1,)
    starts at 0, so at init the unit is the identity.  (b, n, c) → (b, n,
    c)."""

    def __init__(self, in_features: int, use_bn: bool = False):
        super().__init__()
        layer = in_features // 4
        self.conv_f = PointConv(in_features, layer, use_bn=use_bn)
        self.conv_g = PointConv(in_features, layer, use_bn=use_bn)
        self.conv_h = PointConv(in_features, in_features, use_bn=use_bn)
        self.gamma = nn.Parameter(torch.zeros(1))

    def reset_own(self) -> None:
        """``gamma`` back to 0 (:func:`~dispu_tpu_torch.nn.layers.
        init_weights`)."""
        with torch.no_grad():
            self.gamma.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape

        def flat(t):
            return t.reshape(shape[0], -1, t.shape[-1])

        s = torch.einsum("bnc,bmc->bnm", flat(self.conv_g(x)),
                         flat(self.conv_f(x)))
        o = torch.einsum("bnm,bmc->bnc", torch.softmax(s, dim=-1),
                         flat(self.conv_h(x))).reshape(shape)
        return self.gamma * o + x
