"""Peaks of one NVIDIA H100 SXM and the least time of counted work.

Published peaks (NVIDIA's data sheet, dense, at the 700 W limit): HBM
3.35 TB/s; bf16 989 TFLOP/s on the tensor cores; f32 67 TFLOP/s outside
them.  An f32-accurate product is counted at TF32's 495 TFLOP/s over the
three products of 3xTF32 (165 TFLOP/s), the fastest product here that
keeps f32's accuracy.  A unit's least time is the larger of its bytes over
the bandwidth and its operations over its class's peak; each input byte
is read once and each output byte written once.
"""

from __future__ import annotations

import torch

HBM = 3.35e12
F32 = 67e12
F32_PRODUCT = 495e12 / 3
BF16 = 989e12


def least(nbytes: float, ops: float = 0.0, rate: float = F32) -> float:
    """Seconds: ``max(bytes / HBM, ops / rate)``."""
    return max(nbytes / HBM, ops / rate)


def model_least(flops_by_dtype: dict) -> float:
    """Seconds the counted model FLOPs need at their classes' peaks: bf16
    (and fp16) products at :data:`BF16`, every other product at
    :data:`F32_PRODUCT`."""
    return sum(f / (BF16 if dt in (torch.bfloat16, torch.float16)
                    else F32_PRODUCT)
               for dt, f in flops_by_dtype.items())


# ---------------------------------------------------------------- kernels
# Operations as the kernels' bound has always counted them (a multiply-add
# two): FPS ≈ 9 a candidate a round (three differences, three squares, two
# adds, a minimum; the argmax's compare not counted); a kNN 2c + 4 a
# (query, point) pair (the expansion's product and norms, the selection's
# compare); a ball query's scan is data-dependent and counted by its bytes
# alone; attention 4·c a (query, key) pair on bf16 operands.

def fps(b: int, n: int, m: int) -> float:
    """(b, n, 3) → (b, m) int32 picks."""
    return least(12 * b * n + 4 * b * m, 9 * b * n * (m - 1))


def knn(b: int, n: int, m: int, c: int, k: int, dup: bool = False) -> float:
    """(b, n, c) points, (b, m, c) queries → (b, m, k) distances and
    indices; ``dup``: a (b, n) column bias read too."""
    return least(4 * (b * n * c + b * m * c + (b * n if dup else 0))
                 + 8 * b * m * k, b * m * n * (2 * c + 4))


def ball(b: int, n: int, m: int, c: int, ns: int, select: int = 0) -> float:
    """(b, n, c) points, (b, m, c) queries → (b, m, ns) indices, (b, m)
    counts and (b, m, select) picks; bytes only."""
    return least(4 * (b * n * c + b * m * c + b * m * ns + b * m
                      + b * m * select))


def attention(b: int, nq: int, nk: int, c: int, cv: int) -> float:
    """softmax(q kᵀ) v over (b, nq, c), (b, nk, c), (b, nk, cv) → (b, nq,
    cv), f32 in and out, bf16 products."""
    return least(4 * b * (nq * c + nk * c + nk * cv + nq * cv),
                 2 * b * nq * nk * (c + cv), BF16)
