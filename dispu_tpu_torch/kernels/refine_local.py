"""The refiner's fused local + skip branch (``csrc/refine_local.cu``) and
its plain PyTorch version.

Replaces ``refine_local_pallas`` (``dispu_tpu/ops/pallas_kernels.py``),
which ``PointShuffle2`` reaches with ``local_impl='fused'``: from the
grouped ``[centred xyz | raw xyz | feature]`` tensor (b, n, k, cf) and the
pre-folded parameters (:class:`LocalParams`), (b, n, c_out) =
relu(after_conv(pool)) + relu(skip).  On an H100 the kernel runs its
products on the tensor cores at f32 grade (3xTF32), in clusters of two
blocks that share the weights' stream and the heads; see the notes at the
top of ``csrc/refine_local.cu`` and ``csrc/refine_common.cuh``.  Inference
only, as in the JAX package: :class:`RefineLocalFunction` raises in
backward.  Its forward is the custom op ``dispu_tpu_torch::refine_local``,
which takes the parameters as a list in :class:`LocalParams`' order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dispu_tpu_torch.kernels import (LAUNCHES, custom_op, forward_of,
                                     use_kernel)

#: n must be a multiple of this, as ``refine_local_pallas``'s ``tile_n``
TILE_N = 128
#: queries a block at most (the heads' n8 side), and grouped rows a block
#: at most (``refine_common.cuh``'s kMaxT and kMaxRows): k ≤ 128
MAX_TILE_QUERIES = 8
MAX_TILE_ROWS = 128

_P = ctypes.c_void_p
_I = ctypes.c_int


class LocalParams(NamedTuple):
    """The local and skip branches' parameters in the JAX package's layout
    (kernels (in, out)): conv0 ``w0`` (cf, c1), ``b0``; conv1 ``w1`` (c1,
    c2), ``b1``; the weight net ``ww`` (3, k), ``bw`` with its inference
    batch norm folded in; skip ``wsk`` (cf, c_out), ``bsk``; after_conv
    ``waf`` (k, c2, c_out) as t-major row blocks, ``baf``."""

    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    ww: torch.Tensor
    bw: torch.Tensor
    wsk: torch.Tensor
    bsk: torch.Tensor
    waf: torch.Tensor
    baf: torch.Tensor


def refine_local_torch(grouped: torch.Tensor,
                       p: LocalParams) -> torch.Tensor:
    """Plain version: the composed path's math on the pre-folded
    parameters (``tests/test_pallas.py``'s ``_composed``)."""
    b, n = grouped.shape[:2]
    h = torch.relu(torch.relu(grouped @ p.w0 + p.b0) @ p.w1 + p.b1)
    w = torch.relu(grouped[..., :3] @ p.ww + p.bw)          # (b, n, k, k)
    pool = torch.einsum("bnkt,bnkc->bntc", w, h)
    after = torch.relu(pool.reshape(b, n, -1)
                       @ p.waf.reshape(-1, p.waf.shape[-1]) + p.baf)
    skip = torch.relu(torch.amax(grouped, dim=2) @ p.wsk + p.bsk)
    return after + skip


def tile_queries(k: int) -> int:
    """Queries a block takes: as many as keep its grouped rows within
    ``MAX_TILE_ROWS``, at most ``MAX_TILE_QUERIES``; raises ``ValueError``
    for k > ``MAX_TILE_ROWS``."""
    if k > MAX_TILE_ROWS:
        raise ValueError(f"refine kernels take k <= {MAX_TILE_ROWS} "
                         f"neighbours a query, got k={k}")
    return min(MAX_TILE_QUERIES, MAX_TILE_ROWS // k)


def packed_scratch(lib, prefix: str, k: int, cf: int, c1: int, c2: int,
                   c_out: int, device) -> torch.Tensor:
    """The scratch into which a launch lays the weights out in fragment
    order (``refine_common.cuh``'s ``pack_kernel``), sized by the
    library's ``<prefix>_packed``."""
    size = getattr(lib, prefix + "_packed")
    size.argtypes = [_I] * 5
    size.restype = ctypes.c_size_t
    return torch.empty(size(k, cf, c1, c2, c_out), dtype=torch.float32,
                       device=device)


def param_dims(p: LocalParams, k: int, cf: int):
    """(c1, c2, c_out) of ``p``; raises ``ValueError`` where a shape does
    not fit k neighbours of cf-wide grouped rows."""
    c1, c2, c_out = p.w0.shape[-1], p.w1.shape[-1], p.wsk.shape[-1]
    want = dict(w0=(cf, c1), b0=(c1,), w1=(c1, c2), b1=(c2,), ww=(3, k),
                bw=(k,), wsk=(cf, c_out), bsk=(c_out,), waf=(k, c2, c_out),
                baf=(c_out,))
    for name, shape in want.items():
        got = tuple(getattr(p, name).shape)
        if got != shape:
            raise ValueError(f"{name} is {got}, expected {shape}")
    return c1, c2, c_out


def cuda_args(tensors, device) -> list:
    """Contiguous float32 copies on ``device`` (kept alive by the caller)
    of the given tensors; raises for tensors on another device."""
    out = []
    for t in tensors:
        if t.device != device:
            raise ValueError("refine kernel inputs lie on different devices")
        out.append(t.detach().to(torch.float32).contiguous())
    return out


def refine_local_cuda(grouped: torch.Tensor, p: LocalParams) -> torch.Tensor:
    """Launch the kernel.  Same contract as :func:`refine_local_torch`."""
    from dispu_tpu_torch.kernels import _build

    if grouped.dim() != 4 or grouped.dtype != torch.float32 \
            or not grouped.is_cuda:
        raise ValueError("refine_local kernel takes a (b, n, k, cf) float32 "
                         "CUDA tensor")
    b, n, k, cf = grouped.shape
    c1, c2, c_out = param_dims(p, k, cf)
    dev = grouped.device
    g = grouped.contiguous()
    args = cuda_args(p, dev)
    lib = _build.load("refine_local")
    tile = tile_queries(k)
    lib.dispu_refine_local_smem.argtypes = [_I] * 6
    lib.dispu_refine_local_smem.restype = ctypes.c_size_t
    if lib.dispu_refine_local_smem(k, cf, c1, c2, c_out, tile) == 0:
        raise ValueError(
            f"refine_local kernel: a tile of {tile} queries at k={k}, "
            f"cf={cf}, widths ({c1}, {c2}, {c_out}) exceeds one block's "
            "232,448 bytes of shared memory")
    packed = packed_scratch(lib, "dispu_refine_local", k, cf, c1, c2, c_out,
                            dev)
    out = torch.empty((b, n, c_out), dtype=torch.float32, device=dev)
    fn = lib.dispu_refine_local
    fn.argtypes = [_P] * 13 + [_I] * 8 + [_P]
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(g.data_ptr(), *(a.data_ptr() for a in args),
                    packed.data_ptr(), out.data_ptr(), b, n, k, cf, c1, c2,
                    c_out, tile, stream)
    _build.check(status, "refine_local kernel launch")
    LAUNCHES["refine_local"] += 1
    return out


def refine_local_op_torch(grouped: torch.Tensor,
                          params: list[torch.Tensor]) -> torch.Tensor:
    """The op's CPU form: :func:`refine_local_torch`."""
    return refine_local_torch(grouped, LocalParams(*params))


def refine_local_op_cuda(grouped, params):
    """The op's CUDA form: :func:`refine_local_cuda`."""
    return refine_local_cuda(grouped, LocalParams(*params))


def refine_fake(rows, params):
    """The refiner ops' shape: (b, n, c_out) f32, c_out from ``baf``."""
    return rows.new_empty((rows.shape[0], rows.shape[1], params[-1].shape[0]))


refine_local_op = custom_op("refine_local", refine_local_op_torch,
                            refine_local_op_cuda, refine_fake)


class RefineLocalFunction(torch.autograd.Function):
    """The fused branch, forward by the kernel (``use_cuda``) or by
    :func:`refine_local_torch`, through the custom op
    (:func:`~dispu_tpu_torch.kernels.forward_of`).  No backward rule: the
    JAX package's kernel has none, and its training path keeps the
    composed form."""

    @staticmethod
    def forward(ctx, grouped, use_cuda, *params):
        return forward_of(use_cuda, grouped, refine_local_op,
                          refine_local_op_cuda, refine_local_op_torch)(
                              grouped, list(params))

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("refine_local is inference only, as in the JAX "
                           "package: train with the composed refiner")


def refine_local(grouped: torch.Tensor, params: LocalParams,
                 impl: str = "auto") -> torch.Tensor:
    """(b, n, k, cf) grouped rows → (b, n, c_out), the refiner's local and
    skip branches summed.  n must be a multiple of 128, as for
    ``refine_local_pallas``.  The kernel for CUDA tensors, the plain
    version for CPU tensors; inference only (backward raises)."""
    n = grouped.shape[1]
    if n % TILE_N:
        raise ValueError(f"n={n} must be a multiple of tile_n={TILE_N}")
    return RefineLocalFunction.apply(grouped, use_kernel(impl, grouped),
                                     *params)
