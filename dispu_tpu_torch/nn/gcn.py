"""DeepGCN building blocks over point kNN graphs (counterpart of
``nn/gcn.py``): the kNN graph and its (stochastically) dilated form, the
edge, max-relative, GraphSAGE and GIN vertex layers, and the dilated
backbone.

The graphs are the port's kNN, on the card the kNN kernel (``knn.cu``):
at k·dilation = 16, 32 and 48 over the backbone's features, the last
past the tiled form's k ≤ 32, so the radix form.  The JAX package draws
the stochastic dilation's k-subset and its ε gate with ``jax.random``,
whose bits torch cannot make; here :func:`draw_dilation` draws them from
a ``torch.Generator`` and :func:`select_dilated` takes them as inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from dispu_tpu_torch.nn.layers import PointConv, PointMLP
from dispu_tpu_torch.ops.grouping import group_point
from dispu_tpu_torch.ops.knn import knn_indices


# --------------------------------------------------------------- edge layers


def knn_graph(x: torch.Tensor, k: int, impl: str = "auto") -> torch.Tensor:
    """(b, n, c) features → (b, n, k) neighbour indices, self first."""
    return knn_indices(k, x, x, impl=impl)


def draw_dilation(k: int, dilation: int, epsilon: float,
                  generator: torch.Generator):
    """The stochastic dilation's draw: (a k-subset of range(k·dilation) in
    random order, (k,) int64; whether the random subset replaces the
    dilated one, with probability ``epsilon``)."""
    perm = torch.randperm(k * dilation, generator=generator)[:k]
    use_random = bool(torch.rand((), generator=generator) < epsilon)
    return perm, use_random


def select_dilated(idx: torch.Tensor, k: int, dilation: int,
                   perm: Optional[torch.Tensor] = None,
                   use_random: bool = False) -> torch.Tensor:
    """Of (b, n, k·dilation) neighbours, every ``dilation``-th (the first
    k), or with ``use_random`` the columns ``perm``."""
    if dilation == 1:
        return idx[..., :k]
    if use_random:
        return idx[..., perm.to(idx.device)]
    return idx[..., ::dilation][..., :k]


def dilated_knn_graph(x: torch.Tensor, k: int, dilation: int = 1,
                      stochastic: bool = False, epsilon: float = 0.0,
                      generator: Optional[torch.Generator] = None,
                      impl: str = "auto") -> torch.Tensor:
    """The kNN graph at k·dilation, every ``dilation``-th neighbour kept;
    with ``stochastic``, a ``generator`` and ``epsilon`` > 0, a random
    k-subset in its place with probability ``epsilon``
    (:func:`draw_dilation`)."""
    idx = knn_graph(x, k * dilation, impl)
    if dilation > 1 and stochastic and generator is not None and epsilon > 0:
        return select_dilated(idx, k, dilation,
                              *draw_dilation(k, dilation, epsilon, generator))
    return select_dilated(idx, k, dilation)


# ------------------------------------------------------------- vertex layers


class EdgeConvLayer(nn.Module):
    """EdgeConv: MLP([x_i, x_j − x_i]) (``mlp``, ReLU last), max over the
    neighbours."""

    def __init__(self, in_features: int, features: Sequence[int],
                 use_bn: bool = False, bn_momentum: float = 0.95):
        super().__init__()
        self.mlp = PointMLP(2 * in_features, tuple(features),
                            last_activation=torch.relu, use_bn=use_bn,
                            bn_momentum=bn_momentum)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        nbrs = group_point(x, idx)
        center = x[:, :, None, :].expand_as(nbrs)
        return torch.amax(self.mlp(torch.cat([center, nbrs - center], -1)),
                          dim=2)


class MaxRelativeConvLayer(nn.Module):
    """Max-relative GCN: MLP([x_i, max_j(x_j − x_i)])."""

    def __init__(self, in_features: int, features: Sequence[int],
                 use_bn: bool = False, bn_momentum: float = 0.95):
        super().__init__()
        self.mlp = PointMLP(2 * in_features, tuple(features),
                            last_activation=torch.relu, use_bn=use_bn,
                            bn_momentum=bn_momentum)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        rel = torch.amax(group_point(x, idx) - x[:, :, None, :], dim=2)
        return self.mlp(torch.cat([x, rel], dim=-1))


class GraphSAGEConvLayer(nn.Module):
    """GraphSAGE: MLP([x_i, max_j pre(x_j)]), l2-normalized (the norm
    floored at 1e-12)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 use_bn: bool = False, bn_momentum: float = 0.95):
        super().__init__()
        kw = dict(use_bn=use_bn, bn_momentum=bn_momentum)
        self.pre = PointConv(in_features, features[0], **kw)
        self.mlp = PointMLP(in_features + features[0], tuple(features),
                            last_activation=torch.relu, **kw)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        pooled = torch.amax(self.pre(group_point(x, idx)), dim=2)
        out = self.mlp(torch.cat([x, pooled], dim=-1))
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out / torch.clamp_min(norm, 1e-12)


class GINConvLayer(nn.Module):
    """GIN: MLP((1 + eps)·x_i + Σ_j x_j), ``eps`` a (1,) parameter that
    starts at ``init_eps``."""

    def __init__(self, in_features: int, features: Sequence[int],
                 init_eps: float = 0.0, use_bn: bool = False,
                 bn_momentum: float = 0.95):
        super().__init__()
        self.init_eps = init_eps
        self.eps = nn.Parameter(torch.full((1,), float(init_eps)))
        self.mlp = PointMLP(in_features, tuple(features),
                            last_activation=torch.relu, use_bn=use_bn,
                            bn_momentum=bn_momentum)

    def reset_own(self) -> None:
        """``eps`` back to ``init_eps`` (:func:`~dispu_tpu_torch.nn.layers.
        init_weights`)."""
        with torch.no_grad():
            self.eps.fill_(self.init_eps)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        agg = torch.sum(group_point(x, idx), dim=2)
        return self.mlp((1.0 + self.eps) * x + agg)


CONVS = {"edge": EdgeConvLayer, "mr": MaxRelativeConvLayer,
         "sage": GraphSAGEConvLayer, "gin": GINConvLayer}


class GCNBackbone(nn.Module):
    """``depth`` vertex layers ``layer{i}`` of width ``growth_rate``, layer
    i over the kNN graph of the previous output at dilation i + 1 (1 with
    ``dilation`` off; stochastic in training with ``stochastic``), every
    output concatenated after the input: (b, n, in_features) → (b, n,
    out_features = in_features + depth·growth_rate).

    forward(x, generator) draws the stochastic dilation from
    ``generator``; without one the graphs are the plain dilated ones.
    """

    def __init__(self, in_features: int = 3, depth: int = 3,
                 growth_rate: int = 24, k: int = 16, conv: str = "edge",
                 dilation: bool = True, stochastic: bool = False,
                 epsilon: float = 0.2, use_bn: bool = False,
                 bn_momentum: float = 0.95, impl: str = "auto"):
        super().__init__()
        if conv not in CONVS:
            raise ValueError(f"conv must be one of {tuple(CONVS)}, got "
                             f"{conv!r}")
        self.depth, self.k, self.dilation = depth, k, dilation
        self.stochastic, self.epsilon, self.impl = stochastic, epsilon, impl
        width = in_features
        for i in range(depth):
            self.add_module(f"layer{i}", CONVS[conv](
                width, (growth_rate,), use_bn=use_bn,
                bn_momentum=bn_momentum))
            width = growth_rate
        self.out_features = in_features + depth * growth_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats, out = [x], x
        for i in range(self.depth):
            idx = dilated_knn_graph(
                out, self.k, dilation=i + 1 if self.dilation else 1,
                stochastic=self.stochastic and self.training,
                epsilon=self.epsilon, generator=generator, impl=self.impl)
            out = getattr(self, f"layer{i}")(out, idx)
            feats.append(out)
        return torch.cat(feats, dim=-1)
