"""Softmax-attention kernel (``csrc/attention.cu``) and its plain version.

Replaces ``attention_pallas`` (``dispu_tpu/ops/pallas_kernels.py``),
forward only.  On an H100 the function is bound by its bytes (the map must
never reach device memory); the first kernel runs its products on the CUDA
cores and is far from that bound.  See the note at the top of the source.
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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, impl: str = "auto") -> torch.Tensor:
    """The kernel for CUDA tensors; for CPU tensors the plain version in
    the kernel's bf16 numerics (``bf16_operands=True``)."""
    if use_kernel(impl, q):
        return attention_cuda(q, k, v, scale)
    return attention_torch(q, k, v, scale, bf16_operands=True)
