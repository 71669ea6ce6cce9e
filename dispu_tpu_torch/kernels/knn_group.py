"""Fused kNN + neighbourhood gather kernel (``csrc/knn_group.cu``) and its
plain PyTorch version.

Replaces ``knn_group_pallas`` (``dispu_tpu/ops/pallas_kernels.py``): the
backbone's fused edge gather (``nn.edgeconv.edge_parts``, ``drop_first``
with the duplicate bias, features only), the refiner's fused grouping
(``ops.grouping.grouping``, with xyz) and the critic's fused
neighbourhoods.  It runs the kNN kernel's forms (``kernels/knn.py``):
for k (+1 with ``drop_first``) <= ``MAX_STREAM_K`` the tiled distances
and the selection in registers, then each warp copies its queries'
chosen rows over their flattened range (coalesced, ``float4`` where
aligned); beyond, the row form.  It is bound by the distances' FMAs and
the bytes of its gathered rows; see the note at the top of the source.
Its (dists, idx) are bit-equal to the kNN kernel's on the same inputs.
:class:`KnnGroupFunction` carries ``knn_group_pallas_diff``'s backward
rule, whose gather transposes are the deterministic scatter-add kernel of
``kernels/gather_rows.py`` on the card.  The forward is the custom op
``dispu_tpu_torch::knn_group``, whose grouped xyz is an empty tensor
where ``with_xyz`` is False (an op returns no None).
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import (LAUNCHES, custom_op, forward_of,
                                     use_kernel)
from dispu_tpu_torch.kernels.gather_rows import (scatter_rows_cuda,
                                                 scatter_rows_torch)
from dispu_tpu_torch.kernels.knn import (MAX_ROW_FLOATS, MAX_STREAM_K,
                                         knn_torch)

#: the widest feature row the JAX package's kernel takes
MAX_C = 384

_P = ctypes.c_void_p
_I = ctypes.c_int


def rows_at(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (b, n, c) ``table`` at (b, m, k) indices → (b, m, k, c)."""
    b, m, k = idx.shape
    c = table.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(b, m * k, c)
    return torch.gather(table, 1, flat).reshape(b, m, k, c)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 → bf16 (round to nearest even) → f32: the turbo gathers' value
    (``_bf16_terms``' leading term, ``group_point(impl='onehot')``)."""
    return x.to(torch.bfloat16).to(torch.float32)


def knn_group_torch(k: int, points: torch.Tensor, queries: torch.Tensor,
                    feats: torch.Tensor,
                    column_bias: torch.Tensor | None = None,
                    exact: bool = True, with_xyz: bool = True,
                    drop_first: bool = False):
    """Plain version: :func:`knn_torch` with k (or k + 1 with
    ``drop_first``, the first column then dropped), then index gathers of
    ``feats`` (bf16-rounded unless ``exact``) and, with ``with_xyz``, of
    ``points``.  Returns (dists (b, m, k), idx (b, m, k) int32,
    grouped_xyz (b, m, k, 3) or None, grouped_feat (b, m, k, c))."""
    d, idx = knn_torch(k + int(drop_first), points, queries, column_bias)
    if drop_first:
        d, idx = d[..., 1:].contiguous(), idx[..., 1:].contiguous()
    gfeat = rows_at(feats, idx)
    if not exact:
        gfeat = bf16_round(gfeat)
    return d, idx, rows_at(points, idx) if with_xyz else None, gfeat


def _check(k, points, queries, feats, bias, with_xyz, drop_first):
    if points.dim() != 3 or queries.dim() != 3 or feats.dim() != 3:
        raise ValueError("knn_group kernel takes (b, n, c) points and feats "
                         "and (b, m, c) queries")
    b, n, c = points.shape
    if queries.shape[0] != b or queries.shape[2] != c:
        raise ValueError(f"queries {tuple(queries.shape)} do not match "
                         f"points {tuple(points.shape)}")
    if tuple(feats.shape[:2]) != (b, n):
        raise ValueError(f"feats {tuple(feats.shape)} do not match points "
                         f"{tuple(points.shape)}")
    tensors = [points, queries, feats] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("knn_group kernel takes contiguous float32 CUDA "
                             "tensors")
        if t.device != points.device:
            raise ValueError("knn_group kernel inputs lie on different "
                             "devices")
    if bias is not None and tuple(bias.shape) != (b, n):
        raise ValueError(f"column_bias must be (b, n) = {(b, n)}")
    if feats.shape[2] > MAX_C:
        raise ValueError(f"knn_group kernel takes c <= {MAX_C} features, got "
                         f"{feats.shape[2]}")
    if with_xyz and c != 3:
        raise ValueError(f"with_xyz needs 3-d points, got c={c}")
    if not 1 <= k <= n - int(drop_first):
        raise ValueError(f"k={k} (+1 with drop_first) must lie in [1, n={n}]")
    if k + int(drop_first) > MAX_STREAM_K and n + c > MAX_ROW_FLOATS:
        raise ValueError(
            f"knn_group kernel at k={k} (+1 with drop_first) holds a query's "
            f"n + c = {n + c} floats in shared memory; the limit is "
            f"{MAX_ROW_FLOATS}")


def knn_group_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
                   feats: torch.Tensor,
                   column_bias: torch.Tensor | None = None,
                   exact: bool = True, with_xyz: bool = True,
                   drop_first: bool = False):
    """Launch the kernel.  Same contract as :func:`knn_group_torch`."""
    from dispu_tpu_torch.kernels import _build

    _check(k, points, queries, feats, column_bias, with_xyz, drop_first)
    b, n, c = points.shape
    m, cf = queries.shape[1], feats.shape[2]
    dev = points.device
    bias = column_bias
    if bias is None:
        bias = torch.zeros((b, n), dtype=torch.float32, device=dev)
    dists = torch.empty((b, m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    gfeat = torch.empty((b, m, k, cf), dtype=torch.float32, device=dev)
    gxyz = (torch.empty((b, m, k, 3), dtype=torch.float32, device=dev)
            if with_xyz else None)
    fn = _build.load("knn_group").dispu_knn_group
    fn.argtypes = [_P] * 8 + [_I] * 8 + [_P]
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(points.data_ptr(), queries.data_ptr(), bias.data_ptr(),
                    feats.data_ptr(), dists.data_ptr(), idx.data_ptr(),
                    gxyz.data_ptr() if with_xyz else None, gfeat.data_ptr(),
                    b, n, m, c, cf, k, int(drop_first), int(exact), stream)
    _build.check(status, "knn_group kernel launch")
    LAUNCHES["knn_group"] += 1
    return dists, idx, gxyz, gfeat


def _no_none(out, like: torch.Tensor):
    d, idx, gxyz, gfeat = out
    return d, idx, like.new_empty((0,)) if gxyz is None else gxyz, gfeat


def knn_group_op_torch(k: int, points: torch.Tensor, queries: torch.Tensor,
                       feats: torch.Tensor, column_bias: torch.Tensor | None,
                       exact: bool, with_xyz: bool, drop_first: bool
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """The op's CPU form: :func:`knn_group_torch`, the grouped xyz empty
    where ``with_xyz`` is False."""
    return _no_none(knn_group_torch(k, points, queries, feats, column_bias,
                                    exact, with_xyz, drop_first), points)


def knn_group_op_cuda(k, points, queries, feats, column_bias, exact,
                      with_xyz, drop_first):
    """The op's CUDA form: :func:`knn_group_cuda`, likewise."""
    return _no_none(knn_group_cuda(k, points, queries, feats, column_bias,
                                   exact, with_xyz, drop_first), points)


def knn_group_fake(k, points, queries, feats, column_bias, exact, with_xyz,
                   drop_first):
    b, m = queries.shape[:2]
    return (queries.new_empty((b, m, k)),
            queries.new_empty((b, m, k), dtype=torch.int32),
            points.new_empty((b, m, k, 3) if with_xyz else (0,)),
            feats.new_empty((b, m, k, feats.shape[2])))


knn_group_op = custom_op("knn_group", knn_group_op_torch, knn_group_op_cuda,
                         knn_group_fake)


class KnnGroupFunction(torch.autograd.Function):
    """``knn_group_pallas_diff``: forward by the kernel (``use_cuda``) or
    by :func:`knn_group_torch`, through the custom op
    (:func:`~dispu_tpu_torch.kernels.forward_of`); backward
    ``_knn_group_bwd``, the selection
    held fixed.  The grouped-feature and grouped-xyz cotangents scatter-add
    back to ``feats`` and ``points`` at the chosen indices, and the
    distance cotangent gives ``2·g·(q − p)`` to each query and its
    negation, scatter-added, to each chosen point.  The scatter-adds are
    the scatter kernel on the card and ``index_add_`` on the CPU.  Where
    the caller passes one tensor as points, queries and feats (the
    backbone), autograd sums the three gradients into it.  The indices
    and the bias carry no gradient."""

    @staticmethod
    def forward(ctx, k, points, queries, feats, column_bias, exact,
                with_xyz, drop_first, use_cuda):
        run = forward_of(use_cuda, points, knn_group_op, knn_group_cuda,
                         knn_group_torch)
        d, idx, gxyz, gfeat = run(k, points, queries, feats, column_bias,
                                  exact, with_xyz, drop_first)
        ctx.save_for_backward(points, queries, idx)
        ctx.n_feats, ctx.use_cuda = feats.shape[1], use_cuda
        ctx.mark_non_differentiable(idx)
        ctx.set_materialize_grads(False)
        return d, idx, gxyz if with_xyz else None, gfeat

    @staticmethod
    def backward(ctx, g_dist, _g_idx, g_gxyz, g_gfeat):
        points, queries, idx = ctx.saved_tensors
        b, m, k = idx.shape
        flat = idx.reshape(b, m * k)
        n = points.shape[1]
        scat = scatter_rows_cuda if ctx.use_cuda else scatter_rows_torch

        def scatter(g, rows):
            return scat(g.reshape(b, m * k, g.shape[-1]).contiguous(), flat,
                        rows)

        d_feats = (None if g_gfeat is None
                   else scatter(g_gfeat, ctx.n_feats))
        d_points = None if g_gxyz is None else scatter(g_gxyz, n)
        d_queries = None
        if g_dist is not None:
            neighbors = rows_at(points, idx)
            contrib = 2.0 * g_dist[..., None] * (queries[:, :, None, :]
                                                 - neighbors)
            d_queries = torch.sum(contrib, dim=2)
            d_dist = scatter(-contrib, n)
            d_points = d_dist if d_points is None else d_points + d_dist
        return (None, d_points, d_queries, d_feats, None, None, None, None,
                None)


def knn_group(k: int, points: torch.Tensor, queries: torch.Tensor,
              feats: torch.Tensor, column_bias: torch.Tensor | None = None,
              exact: bool = True, with_xyz: bool = True,
              drop_first: bool = False, impl: str = "auto"):
    """The k nearest ``points`` of each query and the gathered rows, as
    ``knn_group_pallas`` returns them: (dists, idx, grouped_xyz or None,
    grouped_feat).  The kernel for CUDA tensors, the plain version for CPU
    tensors.  The distances and the gathered rows are differentiable in
    ``points``, ``queries`` and ``feats`` through
    :class:`KnnGroupFunction`.

    bf16 inputs (bf16 compute) are upcast to f32 exactly, as
    ``knn_group_pallas`` upcasts its tables, and the gathered features
    come back in ``feats``' dtype (exactly: they are its values, or in
    turbo their bf16 rounding)."""
    bias = None if column_bias is None else column_bias.detach()
    dtype = feats.dtype
    d, idx, gxyz, gfeat = KnnGroupFunction.apply(
        k, points.float(), queries.float(), feats.float(), bias, exact,
        with_xyz, drop_first, use_kernel(impl, points))
    return d, idx, gxyz, gfeat.to(dtype)
