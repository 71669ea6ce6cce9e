"""Per-point layer primitives (counterpart of ``nn/layers.py``).

Module and parameter names follow the flax tree (``dense``, ``bn``,
``wconv0`` …) so that ``convert.from_flax_variables`` maps one onto the
other by path.  A dense layer is ``torch.nn.Linear`` (weight stored
(out, in), the transpose of flax's kernel); batch norm is written by hand
with flax's parameter names and convention.

Compute dtype (``GeneratorConfig``'s flax ``dtype``, the configs'
``compute_dtype``): every module that computes at it carries a
``compute_dtype`` attribute, float32 unless :func:`set_compute_dtype`
sets it.  At bfloat16 a dense layer rounds its input, weight and bias to
bf16, takes the bf16 product (f32 sums, one rounding) and then adds the
bias as a second bf16 op, as flax's ``Dense`` does after
``promote_dtype``; batch norm takes its statistics and normalizes in f32
and returns bf16.  The parameters and the running statistics stay f32
tensors, so gradients and Adam's moments stay f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dispu_tpu_torch.config import check_compute_dtype

#: the reference's batch-norm epsilon (contrib.layers.batch_norm)
BN_EPSILON = 1e-3

def set_compute_dtype(module: nn.Module, dtype: str) -> nn.Module:
    """Set the compute dtype (a config's ``compute_dtype``, 'float32' or
    'bfloat16') of every module under ``module`` that has one; the
    parameters are not touched.  Returns ``module``."""
    check_compute_dtype(dtype)
    dtype = getattr(torch, dtype)
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return module


@contextlib.contextmanager
def computing_at(module: nn.Module, dtype: str):
    """:func:`set_compute_dtype` for the block, each module's own compute
    dtype restored after it."""
    before = [(m, m.compute_dtype) for m in module.modules()
              if hasattr(m, "compute_dtype")]
    set_compute_dtype(module, dtype)
    try:
        yield module
    finally:
        for m, dtype in before:
            m.compute_dtype = dtype


def scalar(value: float, like: torch.Tensor):
    """A Python scalar as JAX's weak-typed one meets ``like``: rounded to a
    bf16 tensor's dtype before the op (a 0-d tensor), as it is for an f32
    tensor (the float itself)."""
    if like.dtype == torch.float32:
        return value
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def dense_at(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``x @ weightᵀ + bias`` at the compute ``dtype`` (weight (out, in)):
    ``F.linear`` in f32; otherwise the operands rounded to ``dtype``, the
    product, then the bias added as a separate op (flax rounds the product
    and then the sum, where a fused ``addmm`` would round once)."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    return (torch.matmul(x.to(dtype), weight.to(dtype).t())
            + bias.to(dtype))


def glorot_uniform_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Glorot-uniform init of a (out, in) weight from ``generator``."""
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Glorot-uniform weights and zero biases for every dense layer under
    ``module`` in definition order; batch norm starts at scale 1, bias 0,
    mean 0, variance 1; a module with parameters of its own (an attention
    unit's ``gamma``, a GIN layer's ``eps``) resets them by its
    ``reset_own()``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, _PermutedRowDense)):
            glorot_uniform_(m.weight, generator)
            with torch.no_grad():
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset()
        elif hasattr(m, "reset_own"):
            m.reset_own()


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

    At any compute dtype the statistics and the normalization are at least
    f32 (bf16 ``x`` upcast) and the result takes ``x``'s dtype, as
    flax's ``force_float32_reductions``.

    Under a mesh (``mesh`` set, as :func:`synced_batch_stats` does for a
    train step) the batch moments are the global batch's: the local
    ``E[x]`` and ``E[x²]`` in one tensor, summed over the data axis by a
    differentiable all-reduce and divided by the axis size, then flax's
    formula.  (``torch.nn.SyncBatchNorm`` combines Welford moments
    instead.)  ``.eval()`` never touches a process group.

    With ``freeze_stats`` set (:func:`frozen_running_stats`), a training
    forward normalizes with the batch's moments as ever but leaves the
    running statistics alone: the recompute of a checkpointed forward
    (``remat``), whose first run already moved them once, as flax's
    functional ``batch_stats`` move once under ``jax.checkpoint``.
    """

    #: the device mesh whose global batch the training moments span, or
    #: None for this process's batch
    mesh = None
    #: whether a training forward leaves the running statistics alone
    freeze_stats = False

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
        dtype = x.dtype
        x = x.to(torch.promote_types(dtype, torch.float32))
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = torch.mean(x, dim=axes)
            mean_sq = torch.mean(x * x, dim=axes)
            if self.mesh is not None:
                from dispu_tpu_torch.parallel.mesh import (all_reduce_sum,
                                                           data_size)

                both = all_reduce_sum(torch.cat([mean, mean_sq]),
                                      self.mesh) / data_size(self.mesh)
                mean, mean_sq = both[:mean.shape[0]], both[mean.shape[0]:]
            var = torch.maximum(mean_sq - mean * mean, x.new_zeros(()))
            m = self.momentum
            if not self.freeze_stats:
                with torch.no_grad():
                    self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                    self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mean) * mul + self.bias).to(dtype)


@contextlib.contextmanager
def synced_batch_stats(module: nn.Module, mesh):
    """Every :class:`BatchNorm` under ``module`` takes its training
    moments over ``mesh``'s global batch inside the block (nothing changes
    when ``mesh`` is None)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    if mesh is None or not norms:
        yield
        return
    for m in norms:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in norms:
            m.mesh = None


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Every :class:`BatchNorm` under ``module`` leaves its running
    statistics alone in a training forward inside the block."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.freeze_stats = True
    try:
        yield
    finally:
        for m in norms:
            m.freeze_stats = False


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

    def effective_weight(self) -> torch.Tensor:
        """The (features, b·a) weight the apply uses: column j·a + i holds
        stored row i·b + j."""
        a, b = self.inner
        f = self.weight.shape[0]
        return self.weight.reshape(f, a, b).transpose(1, 2).reshape(f, a * b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.effective_weight(), self.bias)


class PointConv(nn.Module):
    """Dense over channels ≡ the reference's 1×1 conv, optional batch norm,
    then the activation (ReLU by default, ``None`` for linear), at
    ``compute_dtype``."""

    compute_dtype = torch.float32

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
        dense = self.dense
        weight = (dense.effective_weight()
                  if isinstance(dense, _PermutedRowDense) else dense.weight)
        x = dense_at(x, weight, dense.bias, self.compute_dtype)
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
