"""Softmax-attention kernel (``csrc/attention.cu``) and its plain version.

Replaces ``attention_pallas`` (``dispu_tpu/ops/pallas_kernels.py``).  On
an H100 the function is bound by its bytes (the map must never reach
device memory).  The kernel rounds q, k and v to bf16 once a call, into
scratch that :func:`attention_cuda` allocates, and runs both products on
the tensor cores (``mma.sync``, f32 accumulators), keeping the TPU
kernel's rounding points; see the note at the top of the source.  bf16
q, k and v (the refiner at bf16 compute) go to the source's bf16 entry,
which reads them where they lie and gives the f32 entry's bits for the
same values (``LAUNCHES["attention_bf16"]``).
:func:`attention` is differentiable through :class:`AttentionFunction`,
which carries ``attention_pallas_diff``'s backward rule in torch ops; its
forward is the custom op ``dispu_tpu_torch::attention``.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import (LAUNCHES, custom_op, forward_of,
                                     use_kernel)

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

    ``bf16_operands=False`` is ``attention_xla``'s einsum, which the
    CPU path uses as JAX's CPU path does: in f32, or for bf16 operands
    (bf16 compute) at bf16, each op rounded to bf16 as XLA rounds it
    (the products with f32 sums, the scale rounded to bf16 first, the
    softmax's max, difference, exp, sum and quotient; the result bf16).
    ``True`` rounds q, k, v and p to bf16 where the TPU kernel and the
    CUDA kernel round them (the denominator sums the unrounded f32 p) and
    returns f32, for f32 or bf16 operands alike.
    """
    if not bf16_operands and q.dtype == torch.bfloat16:
        s = torch.einsum("bqc,bnc->bqn", q, k)
        s = s * torch.tensor(scale, dtype=s.dtype, device=s.device)
        e = torch.exp(s - torch.amax(s.detach(), dim=-1, keepdim=True))
        p = e / torch.sum(e, dim=-1, keepdim=True)
        return torch.einsum("bqn,bnc->bqc", p, v)
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
    """Launch the kernel: the f32 entry for f32 q, k, v, the bf16 entry
    for bf16 ones (all three of one dtype); f32 out.  Same values as
    ``attention_torch(..., bf16_operands=True)`` up to the order of the
    f32 sums."""
    from dispu_tpu_torch.kernels import _build

    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attention kernel takes (b, n, c) tensors")
    b, nq, c = q.shape
    nk, cv = v.shape[1], v.shape[2]
    if tuple(k.shape) != (b, nk, c) or v.shape[0] != b:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    bf16 = q.dtype == torch.bfloat16
    for t in (q, k, v):
        if (t.dtype not in (torch.float32, torch.bfloat16)
                or t.dtype != q.dtype or not t.is_cuda
                or not t.is_contiguous()):
            raise ValueError("attention kernel takes contiguous float32 "
                             "or bfloat16 CUDA tensors of one dtype")
        if t.device != q.device:
            raise ValueError("attention kernel inputs lie on different "
                             "devices")
    if not (1 <= c <= MAX_C and 1 <= cv <= MAX_CV and nq >= 1 and nk >= 1):
        raise ValueError(f"attention kernel takes c <= {MAX_C} and "
                         f"cv <= {MAX_CV}, got c={c}, cv={cv}")
    out = torch.empty((b, nq, cv), dtype=torch.float32, device=q.device)
    lib = _build.load("attention")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if bf16:  # the tensors off the kernel's tiles, copied and padded
        size = lib.dispu_attention_bf16_scratch_bytes
        size.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I]
        size.restype = ctypes.c_longlong
        nbytes = size(*ptrs, b, nq, nk, c, cv)
        fn, name = lib.dispu_attention_bf16, "attention_bf16"
    else:  # q, k and v in bf16, zero-padded to the kernel's tiles
        size = lib.dispu_attention_scratch_bytes
        size.argtypes = [_I, _I, _I, _I, _I]
        size.restype = ctypes.c_longlong
        nbytes = size(b, nq, nk, c, cv)
        fn, name = lib.dispu_attention, "attention"
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=q.device)
               if nbytes else None)
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
                   _P]
    fn.restype = _I
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(*ptrs, out.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), b, nq,
                    nk, c, cv, float(scale), stream)
    _build.check(status, f"{name} kernel launch")
    LAUNCHES[name] += 1
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
    (b, nq, nk) f32: 117 MB at (28, 1024, 1024).  bf16 operands are
    upcast, and each gradient comes back in its operand's dtype.  Returns
    (dq, dk, dv)."""
    dtypes = (q.dtype, k.dtype, v.dtype)
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqc,bnc->bqn", q, k) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bqn,bqc->bnc", p, do)
    dp = torch.einsum("bqc,bnc->bqn", do, v)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = scale * torch.einsum("bqn,bnc->bqc", ds, k)
    dk = scale * torch.einsum("bqn,bqc->bnc", ds, q)
    return tuple(g.to(dt) for g, dt in zip((dq, dk, dv), dtypes))


def attention_op_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """The op's CPU form: :func:`attention_torch` in the kernel's bf16
    numerics."""
    return attention_torch(q, k, v, scale, bf16_operands=True)


def attention_fake(q, k, v, scale):
    """f32 out for f32 or bf16 operands (the op's two signatures)."""
    return q.new_empty((q.shape[0], q.shape[1], v.shape[2]),
                       dtype=torch.float32)


attention_op = custom_op("attention", attention_op_torch, attention_cuda,
                         attention_fake)


class AttentionFunction(torch.autograd.Function):
    """Attention whose output is differentiable in q, k and v: forward by
    the kernel (``use_cuda``) or by its plain bf16 version, through the
    custom op (:func:`~dispu_tpu_torch.kernels.forward_of`), backward by
    :func:`attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, scale, use_cuda):
        out = forward_of(use_cuda, q, attention_op, attention_cuda,
                         attention_op_torch)(q, k, v, scale)
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
    the kernel's bf16 numerics (``bf16_operands=True``).  f32 or bf16
    operands, f32 out.  Differentiable in q, k and v."""
    return AttentionFunction.apply(q, k, v, scale, use_kernel(impl, q))
