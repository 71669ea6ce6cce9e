"""The refiner's non-local attention cell (counterpart of ``nn/attention.py``).

``global_attention`` keeps the JAX package's dispatch rule: the attention
kernel runs where the map is large (nq·nk ≥ 512²) and the widths fit, on
the card here as on the TPU there; elsewhere the f32 composition runs, as
XLA's einsum does in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from dispu_tpu_torch.kernels import IMPLS
from dispu_tpu_torch.kernels.attention import attention, attention_torch
from dispu_tpu_torch.nn.layers import PointConv


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
