"""Softmax-attention kernel (``csrc/attention.cu``) and its plain version.

Replaces ``attention_pallas`` (``dispu_tpu/ops/pallas_kernels.py``).  On
an H100 the function is bound by its bytes (the map must never reach
device memory); the first kernel runs its products on the CUDA cores and
is far from that bound.  See the note at the top of the source.
:func:`attention` is differentiable through :class:`AttentionFunction`,
which carries ``attention_pallas_diff``'s backward rule in torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import LAUNCHES, use_kernel

#: widths the kernel takes
MAX_C = 256
MAX_CV = 256

_P = ctypes.c_void_p
_I = ctypes.c_int


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, bf16_operands: bool = False) -> torch.Tensor:
    """Plain ``softmax(scale · q kᵀ) v`` in f32.

    ``bf16_operands=False`` is ``attention_xla``'s f32 einsum, which the
    CPU path uses as JAX's CPU path does.  ``True`` rounds q, k, v and p
    to bf16 where the TPU kernel and the CUDA kernel round them (the
    denominator sums the unrounded f32 p).
    """
    if not bf16_operands:
        s = torch.einsum("bqc,bnc->bqn", q, k) * scale
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bqn,bnc->bqc", p, v)
    s = torch.einsum("bqc,bnc->bqn", _bf16(q), _bf16(k)) * scale
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    denom = torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bqn,bnc->bqc", _bf16(p), _bf16(v)) / denom


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Launch the kernel.  Same values as ``attention_torch(...,
    bf16_operands=True)`` up to the order of the f32 sums."""
    from dispu_tpu_torch.kernels import _build

    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attention kernel takes (b, n, c) tensors")
    b, nq, c = q.shape
    nk, cv = v.shape[1], v.shape[2]
    if tuple(k.shape) != (b, nk, c) or v.shape[0] != b:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    for t in (q, k, v):
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("attention kernel takes contiguous float32 "
                             "CUDA tensors")
        if t.device != q.device:
            raise ValueError("attention kernel inputs lie on different "
                             "devices")
    if not (1 <= c <= MAX_C and 1 <= cv <= MAX_CV and nq >= 1 and nk >= 1):
        raise ValueError(f"attention kernel takes c <= {MAX_C} and "
                         f"cv <= {MAX_CV}, got c={c}, cv={cv}")
    out = torch.empty((b, nq, cv), dtype=torch.float32, device=q.device)
    fn = _build.load("attention").dispu_attention
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, nq, nk, c, cv, float(scale), stream)
    _build.check(status, "attention kernel launch")
    LAUNCHES["attention"] += 1
    return out


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, do: torch.Tensor):
    """``_attention_bwd`` of the JAX package: the map recomputed in f32,
    then the softmax-attention VJP (dV = pᵀ·do, ds = p ∘ (do·vᵀ −
    Σ(do·vᵀ ∘ p)), dQ = scale·ds·k, dK = scale·dsᵀ·q).

    The TPU ran these einsums at DEFAULT precision (one bf16 pass); here
    they run in f32, the numerics of the reference on the CPU, which
    needs ``allow_tf32 = False`` on the card (``inference.pin_f32``; the
    train step sets it).  At the training shape the recomputed map is
    (b, nq, nk) f32: 117 MB at (28, 1024, 1024).  Returns (dq, dk, dv)."""
    s = torch.einsum("bqc,bnc->bqn", q, k) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bqn,bqc->bnc", p, do)
    dp = torch.einsum("bqc,bnc->bqn", do, v)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = scale * torch.einsum("bqn,bnc->bqc", ds, k)
    dk = scale * torch.einsum("bqn,bqc->bnc", ds, q)
    return dq, dk, dv


class AttentionFunction(torch.autograd.Function):
    """Attention whose output is differentiable in q, k and v: forward by
    the kernel (``use_cuda``) or by its plain bf16 version, backward by
    :func:`attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, use_cuda):
        out = (attention_cuda(q, k, v, scale) if use_cuda
               else attention_torch(q, k, v, scale, bf16_operands=True))
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, ctx.scale, do), None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, impl: str = "auto") -> torch.Tensor:
    """The kernel for CUDA tensors; for CPU tensors the plain version in
    the kernel's bf16 numerics (``bf16_operands=True``).  Differentiable in
    q, k and v."""
    return AttentionFunction.apply(q, k, v, scale, use_kernel(impl, q))
