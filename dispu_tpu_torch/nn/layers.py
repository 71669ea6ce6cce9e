"""Per-point layer primitives (counterpart of ``nn/layers.py``).

Module and parameter names follow the flax tree (``dense``, ``bn``,
``wconv0`` …) so that ``convert.from_flax_variables`` maps one onto the
other by path.  A dense layer is ``torch.nn.Linear`` (weight stored
(out, in), the transpose of flax's kernel); batch norm is written by hand
with flax's parameter names and convention.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

#: the reference's batch-norm epsilon (contrib.layers.batch_norm)
BN_EPSILON = 1e-3


def glorot_uniform_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Glorot-uniform init of a (out, in) weight from ``generator``."""
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Glorot-uniform weights and zero biases for every dense layer under
    ``module`` in definition order; batch norm starts at scale 1, bias 0,
    mean 0, variance 1."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, _PermutedRowDense)):
            glorot_uniform_(m.weight, generator)
            with torch.no_grad():
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset()


class BatchNorm(nn.Module):
    """Batch norm over the last axis in flax's convention.

    Parameters ``scale`` and ``bias``, running statistics ``mean`` and
    ``var`` (flax's ``batch_stats``).  Normalizes as flax does:
    ``(x − mean) · (rsqrt(var + eps) · scale) + bias``, with the running
    statistics in ``.eval()`` mode and the batch's in ``.train()`` mode.
    The batch statistics are flax's (``use_fast_variance``): the mean over
    every axis but the last, and the biased variance ``max(0, E[x²] −
    E[x]²)``.  Each training forward then moves the running statistics as
    flax does, ``mean ← m·mean + (1 − m)·batch_mean`` (m = ``momentum``,
    0.95) and the same for ``var``: the opposite direction to
    ``torch.nn.BatchNorm1d``'s momentum, whose running variance is also
    unbiased.
    """

    def __init__(self, features: int, momentum: float = 0.95,
                 epsilon: float = BN_EPSILON):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = torch.mean(x, dim=axes)
            var = torch.maximum(torch.mean(x * x, dim=axes) - mean * mean,
                                x.new_zeros(()))
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * mul + self.bias


class _PermutedRowDense(nn.Module):
    """Dense whose stored kernel rows are (a, b)-major while its input
    arrives (b, a)-major flattened.

    ``weight`` is flax's (a·b, features) kernel transposed to (features,
    a·b), rows in their stored order; the apply permutes them, as
    ``_PermutedRowDense`` in the JAX package does, so checkpoints keep the
    reference layout.
    """

    def __init__(self, inner: tuple, features: int):
        super().__init__()
        self.inner = tuple(inner)
        a, b = self.inner
        self.weight = nn.Parameter(torch.zeros(features, a * b))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.inner
        f = self.weight.shape[0]
        w = self.weight.reshape(f, a, b).transpose(1, 2).reshape(f, a * b)
        return F.linear(x, w, self.bias)


class PointConv(nn.Module):
    """Dense over channels ≡ the reference's 1×1 conv, optional batch norm,
    then the activation (ReLU by default, ``None`` for linear)."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[Callable] = torch.relu,
                 use_bn: bool = False, bn_momentum: float = 0.95,
                 kernel_row_perm: Optional[tuple] = None):
        super().__init__()
        if kernel_row_perm is not None:
            a, b = kernel_row_perm
            if a * b != in_features:
                raise ValueError(f"kernel_row_perm {kernel_row_perm} does not "
                                 f"cover {in_features} inputs")
            self.dense = _PermutedRowDense(kernel_row_perm, features)
        else:
            self.dense = nn.Linear(in_features, features)
        self.bn = BatchNorm(features, bn_momentum) if use_bn else None
        self.activation = activation
        self.features = features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class PointMLP(nn.Module):
    """A stack of PointConvs ``layer{i}``; the last takes
    ``last_activation``."""

    def __init__(self, in_features: int, features: Sequence[int],
                 last_activation: Optional[Callable] = None,
                 activation: Callable = torch.relu, use_bn: bool = False,
                 bn_momentum: float = 0.95):
        super().__init__()
        n = len(features)
        for i, c in enumerate(features):
            act = activation if i < n - 1 else last_activation
            self.add_module(f"layer{i}", PointConv(
                in_features, c, activation=act, use_bn=use_bn,
                bn_momentum=bn_momentum))
            in_features = c
        self.num_layers = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        return x


class WeightNetHidden(nn.Module):
    """Small MLP over relative coordinates producing pooling weights; every
    layer carries batch norm, as the reference hard-codes."""

    def __init__(self, in_features: int, hidden_units: Sequence[int],
                 bn_momentum: float = 0.95):
        super().__init__()
        for i, h in enumerate(hidden_units):
            self.add_module(f"wconv{i}", PointConv(
                in_features, h, use_bn=True, bn_momentum=bn_momentum))
            in_features = h
        self.num_layers = len(hidden_units)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            xyz = getattr(self, f"wconv{i}")(xyz)
        return xyz
