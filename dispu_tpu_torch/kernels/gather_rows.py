"""Exact row gather and deterministic row scatter-add kernels
(``csrc/gather_rows.cu``) and their plain PyTorch versions.

Replaces ``gather_rows_pallas`` and ``scatter_rows_pallas``
(``dispu_tpu/ops/pallas_kernels.py``): :class:`GatherRowsFunction` is
``gather_rows_pallas_diff``, the gather forward and the scatter-add as its
backward, which ``group_point(gather_impl='pallas')`` runs for every gather
inside the JAX package's gate.  The scatter is also the gather transpose of
``knn_group``'s backward rule.  On an H100 both kernels are bound by the
bytes of the rows they move; see the note at the top of the source.  The
gather is bit-equal to ``torch.gather``; the scatter sums each row in
ascending source position, so it is bit-equal run to run and, on the CPU,
to ``index_add_``.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import LAUNCHES, use_kernel

#: the scatter keeps a running slot for each of the n destination rows in
#: one block's shared memory (232,448 bytes on Hopper)
SCATTER_MAX_N = 232448 // 4
#: positions a segment of the scatter's counting sort (its block size)
SEGMENT = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int


def gather_rows_torch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: (b, n, c) ``table``, (b, q) indices → (b, q, c)."""
    c = table.shape[-1]
    return torch.gather(table, 1, idx.long()[..., None].expand(-1, -1, c))


def scatter_rows_torch(g: torch.Tensor, idx: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Plain version: ``zeros((b, n, c)).at[idx].add(g)`` by
    ``index_add_`` on the flattened rows; (b, q, c) ``g``, (b, q) indices
    in [0, n) → (b, n, c)."""
    b, q, c = g.shape
    flat = (idx.long() + n * torch.arange(b, device=g.device)[:, None])
    out = torch.zeros((b * n, c), dtype=g.dtype, device=g.device)
    return out.index_add_(0, flat.reshape(-1), g.reshape(b * q, c)).reshape(
        b, n, c)


def _check(what, rows, idx, n):
    if rows.dim() != 3 or idx.dim() != 2 or idx.shape[0] != rows.shape[0]:
        raise ValueError(f"{what} takes (b, ., c) rows and (b, q) indices, "
                         f"got {tuple(rows.shape)} and {tuple(idx.shape)}")
    if rows.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"{what} takes float32 rows and int32 indices")
    for t in (rows, idx):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous CUDA tensors")
    if idx.device != rows.device:
        raise ValueError(f"{what} inputs lie on different devices")
    if min(rows.shape) < 1 or idx.shape[1] < 1 or n < 1:
        raise ValueError(f"{what} needs non-empty inputs")


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the gather kernel.  Same contract as
    :func:`gather_rows_torch`; an index outside [0, n) gives zeros."""
    from dispu_tpu_torch.kernels import _build

    _check("gather_rows kernel", table, idx, table.shape[1])
    b, n, c = table.shape
    q = idx.shape[1]
    out = torch.empty((b, q, c), dtype=torch.float32, device=table.device)
    fn = _build.load("gather_rows").dispu_gather_rows
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, q,
                    c, stream)
    _build.check(status, "gather_rows kernel launch")
    LAUNCHES["gather_rows"] += 1
    return out


def scatter_rows_cuda(g: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Launch the scatter kernel (its four passes count as one launch).
    Same contract as :func:`scatter_rows_torch`, for n ≤
    :data:`SCATTER_MAX_N`; an index outside [0, n) is dropped."""
    from dispu_tpu_torch.kernels import _build

    _check("scatter_rows kernel", g, idx, n)
    b, q, c = g.shape
    if idx.shape[1] != q:
        raise ValueError(f"indices {tuple(idx.shape)} do not match rows "
                         f"{tuple(g.shape)}")
    if n > SCATTER_MAX_N:
        raise ValueError(f"scatter_rows kernel takes n <= {SCATTER_MAX_N} "
                         f"rows, got {n}")
    dev = g.device
    nseg = -(-q // SEGMENT)
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    counts = torch.empty(b * nseg * n, dtype=torch.int32, device=dev)
    rowptr = torch.empty(b * (n + 1), dtype=torch.int32, device=dev)
    perm = torch.empty(b * q, dtype=torch.int32, device=dev)
    fn = _build.load("gather_rows").dispu_scatter_rows
    fn.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(g.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    counts.data_ptr(), rowptr.data_ptr(), perm.data_ptr(), b,
                    n, q, c, stream)
    _build.check(status, "scatter_rows kernel launch")
    LAUNCHES["scatter_rows"] += 1
    return out


class GatherRowsFunction(torch.autograd.Function):
    """``gather_rows_pallas_diff``: the gather, differentiable in the
    table, whose backward is the scatter-add (``use_cuda``: the kernels;
    else the plain versions).  The indices carry no gradient."""

    @staticmethod
    def forward(ctx, table, idx, use_cuda):
        ctx.save_for_backward(idx)
        ctx.n, ctx.use_cuda = table.shape[1], use_cuda
        run = gather_rows_cuda if use_cuda else gather_rows_torch
        return run(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        run = scatter_rows_cuda if ctx.use_cuda else scatter_rows_torch
        return run(g.contiguous(), idx, ctx.n), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """Rows of (b, n, c) ``table`` at (b, q) indices → (b, q, c), through
    :class:`GatherRowsFunction`: the kernels for CUDA tensors, the plain
    versions for CPU tensors."""
    use_cuda = use_kernel(impl, table)
    if use_cuda:
        table = table.float().contiguous()
        idx = idx.to(torch.int32).contiguous()
    return GatherRowsFunction.apply(table, idx, use_cuda)
