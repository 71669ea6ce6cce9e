"""Neighbourhood gathers (counterpart of ``ops/grouping.py``).

The exact gathers of the JAX package 'gather', 'onehot_hp' and 'onehot3'
(one-hot MXU contractions it proves bit-identical to a gather) are one
plain index gather here: on the card a load is exact, so the TPU's one-hot
detour has no reason to exist.  'pallas' runs the gather kernel and, as
its backward, the deterministic scatter-add kernel
(``kernels/gather_rows.py``) on the card inside the JAX package's gate for
``gather_rows_pallas``, and the plain gather elsewhere.  The turbo gather
'onehot' is the plain gather rounded to bf16, with its bf16 contraction's
transpose as its gradient (the scatter-add kernel's f32 sums on the
card).  The ball query runs the
ball-query kernel, and the fused kNN + gather (``gather_impl`` 'fused' /
'fused_turbo') the ``knn_group`` kernel, on the card where the JAX
package's gates admit their Pallas kernels.

At bf16 compute the JAX package's gates route as they do there: the
gather kernel takes f32 tables only (the backbone's bf16 features take
the plain gather; the refiner's combined ``[xyz | feature]`` table is
f32), and the fused kernel upcasts its tables
(:func:`~dispu_tpu_torch.kernels.knn_group.knn_group`).
"""

from __future__ import annotations

import torch

from dispu_tpu_torch.config import EXACT_GATHERS
from dispu_tpu_torch.kernels import IMPLS, use_kernel
from dispu_tpu_torch.kernels import knn_group as _knn_group
from dispu_tpu_torch.kernels.gather_rows import (gather_rows,
                                                 scatter_rows_cuda,
                                                 scatter_rows_torch)
from dispu_tpu_torch.kernels import query_ball as _ball
from dispu_tpu_torch.ops.knn import knn_indices


def query_ball_point(radius, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, impl: str = "auto",
                     return_dists: bool = False, select_smallest: int = 0):
    """First ``nsample`` points of (b, n, c) ``xyz`` within ``radius`` (a
    scalar or (b,)) of each (b, m, c) query, in index order.

    Returns (idx (b, m, nsample) int32, counts (b, m) int32) and, as asked,
    the slots' squared distances (b, m, nsample) and the indices of the
    ``select_smallest`` nearest slots (b, m, select_smallest); see
    :mod:`dispu_tpu_torch.kernels.query_ball` for the contract.  None of
    them carries a gradient.

    impl 'auto': the kernel for CUDA tensors when n ≤ 4096, c ≤ 128 and
    nsample ≤ 128 (the JAX package's gate for its Pallas kernel), the
    plain version otherwise; 'cuda' insists on the kernel (and raises
    outside its limits); 'torch' runs the plain version.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if select_smallest > nsample:
        raise ValueError(f"select_smallest={select_smallest} exceeds "
                         f"nsample={nsample}")
    fits = (xyz.shape[1] <= _ball.MAX_N and xyz.shape[-1] <= _ball.MAX_C
            and nsample <= _ball.MAX_NSAMPLE)
    if impl == "auto" and not fits:
        impl = "torch"
    return _ball.query_ball(radius, nsample, xyz.float(), new_xyz.float(),
                            return_dists, select_smallest, impl=impl)


def _rows_fit(n: int, c: int) -> bool:
    """``gather_fits``' shape half: n ≤ 4096, c ≤ 256, n·c ≤ 4096·128."""
    return n <= 4096 and c <= 256 and n * c <= 4096 * 128


def gather_fits(points: torch.Tensor) -> bool:
    """The JAX package's gate for ``gather_rows_pallas`` in
    ``group_point(impl='pallas')`` (f32, n ≤ 4096, c ≤ 256, n·c ≤
    4096·128), without its backend test."""
    return points.dtype == torch.float32 and _rows_fit(*points.shape[-2:])


class Bf16GatherFunction(torch.autograd.Function):
    """The turbo gather ``group_point(impl='onehot')``: the JAX package's
    bf16 one-hot contraction ``einsum('bqn,bnc->bqc', onehot, bf16(points))``
    and its transpose, without the one-hot.

    Forward: the rows at the indices rounded to bf16 (to nearest even),
    in the table's dtype.  Backward, the contraction's transpose as XLA
    computes it: the cotangent rounded to bf16, summed into the table's
    rows in f32 (one bf16 product's f32 sums), the sum rounded to bf16.
    The sum is the scatter-add kernel (``kernels/gather_rows.py``) for a
    CUDA table whose (n, c) fits ``gather_fits``' shape gate when
    ``use_cuda``, else ``index_add_`` (deterministic on the card under
    the train step's deterministic algorithms).  The indices carry no
    gradient."""

    @staticmethod
    def forward(ctx, points, idx, use_cuda):
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype, ctx.use_cuda = points.shape[1], points.dtype, use_cuda
        return _knn_group.bf16_round(
            _knn_group.rows_at(points, idx)).to(points.dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, m, k = idx.shape
        c = g.shape[-1]
        g = _knn_group.bf16_round(g.float()).reshape(b, m * k, c).contiguous()
        flat = idx.reshape(b, m * k)
        if ctx.use_cuda and g.is_cuda and _rows_fit(ctx.n, c):
            s = scatter_rows_cuda(g, flat.to(torch.int32).contiguous(), ctx.n)
        else:
            s = scatter_rows_torch(g, flat, ctx.n)
        return _knn_group.bf16_round(s).to(ctx.dtype), None, None


def group_point(points: torch.Tensor, idx: torch.Tensor,
                gather_impl: str = "gather",
                impl: str = "auto") -> torch.Tensor:
    """(b, n, c) points, (b, m, k) indices → (b, m, k, c).

    ``gather_impl`` 'pallas': the gather kernel, differentiable through
    the scatter-add kernel, for CUDA tensors inside :func:`gather_fits`
    (``impl`` 'cuda' raises outside it; 'torch' takes the plain gather).
    ``'onehot'`` is the turbo gather (:class:`Bf16GatherFunction`): the
    JAX package's bf16 one-hot contraction, whose values are the gathered
    rows rounded to bf16 (to nearest even), and whose gradient is that
    contraction's transpose.  Every other exact ``gather_impl`` is the
    plain gather.
    """
    if gather_impl not in EXACT_GATHERS + ("onehot",):
        raise ValueError(f"group_point takes gather_impl in "
                         f"{EXACT_GATHERS + ('onehot',)}, got "
                         f"{gather_impl!r}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if gather_impl == "onehot":
        return Bf16GatherFunction.apply(points, idx,
                                        use_kernel(impl, points))
    if gather_impl == "pallas":
        fits = gather_fits(points)
        if impl == "cuda" and not fits:
            raise ValueError(
                f"gather_rows kernel takes f32 points with n <= 4096, "
                f"c <= 256 and n*c <= 524288, got {tuple(points.shape)} "
                f"{points.dtype}")
        if fits and use_kernel(impl, points):
            b, m, k = idx.shape
            out = gather_rows(points, idx.reshape(b, m * k), impl="cuda")
            return out.reshape(b, m, k, points.shape[-1])
    return _knn_group.rows_at(points, idx)


def _fused_fits(feature, src_xyz) -> bool:
    """The JAX package's gate for its fused kNN + gather kernel in
    ``grouping`` (n ≤ 2048, c ≤ 384, 3-d keys), without its backend
    test."""
    return (src_xyz.shape[1] <= 2048 and feature.shape[-1] <= _knn_group.MAX_C
            and src_xyz.shape[-1] == 3)


def grouping(feature: torch.Tensor, k: int, src_xyz: torch.Tensor,
             q_xyz: torch.Tensor, use_xyz: bool = True, use_knn: bool = True,
             radius: float = 0.2, gather_impl: str = "gather",
             impl: str = "auto", knn_variant: str = "auto"):
    """kNN (or, with ``use_knn=False``, ball) neighbourhoods of the query
    points with their gathered features.

    Returns (grouped_xyz (b, m, k, 3), grouped_feature (b, m, k, 3 + c or
    c), idx (b, m, k)).  An exact ``gather_impl``: one combined ``[xyz |
    feature]`` gather, as on the JAX package's exact path.  ``'onehot'``
    (turbo): the xyz gathered exactly, the features bf16-rounded.
    ``'fused'`` / ``'fused_turbo'``: the kNN and both gathers in the
    ``knn_group`` kernel (features exact / bf16-rounded) inside the JAX
    package's gate, the composed ``'onehot_hp'`` / ``'onehot'`` path
    outside it; with the ball query (``use_knn=False``) both are the
    exact combined gather, as the JAX package's ``group_point`` takes
    their names.  ``knn_variant`` ('auto' or 'packed') picks the composed
    path's kNN selection.
    """
    if not use_knn and gather_impl in ("fused", "fused_turbo"):
        gather_impl = "gather"
    if use_knn and gather_impl in ("fused", "fused_turbo"):
        if _fused_fits(feature, src_xyz):
            _, idx, grouped_xyz, grouped_feature = _knn_group.knn_group(
                k, src_xyz.float().contiguous(), q_xyz.float().contiguous(),
                feature.contiguous(), exact=gather_impl == "fused",
                with_xyz=True, impl=impl)
            if use_xyz:
                grouped_feature = torch.cat([grouped_xyz, grouped_feature],
                                            dim=-1)
            return grouped_xyz, grouped_feature, idx
        gather_impl = "onehot_hp" if gather_impl == "fused" else "onehot"
    if use_knn:
        idx = knn_indices(k, src_xyz, q_xyz, impl=impl, variant=knn_variant)
    else:
        idx, _ = query_ball_point(radius, k, src_xyz, q_xyz, impl=impl)
    if gather_impl != "onehot":
        combined = group_point(torch.cat([src_xyz, feature], dim=-1), idx,
                               gather_impl, impl=impl)
        grouped_xyz = combined[..., :3]
        grouped_feature = combined if use_xyz else combined[..., 3:]
        return grouped_xyz, grouped_feature, idx
    # turbo: the features round, the xyz must stay exact
    grouped_xyz = group_point(src_xyz, idx)
    grouped_feature = group_point(feature, idx, gather_impl, impl=impl)
    if use_xyz:
        grouped_feature = torch.cat([grouped_xyz, grouped_feature], dim=-1)
    return grouped_xyz, grouped_feature, idx


def selection_sort(dist: torch.Tensor, k: int):
    """The k smallest entries of each row of ``dist`` and their indices,
    ascending, ties to the lower index (the reference's ``selection_sort``
    op, ``-top_k(-dist, k)`` in the JAX package) → ((..., k), (..., k)
    int32)."""
    values, idx = torch.sort(dist, dim=-1, stable=True)
    return values[..., :k], idx[..., :k].to(torch.int32)


def dilat_group(xyz: torch.Tensor, points: torch.Tensor | None, k: int,
                dilation: int = 1, use_xyz: bool = False,
                impl: str = "auto"):
    """Dilated kNN grouping: of the k·dilation + 1 nearest points of each
    point (the kNN kernel on the card), every ``dilation``-th after the
    self column.  Returns (grouped_xyz (b, n, k, 3) centred on each point,
    grouped points (b, n, k, c), or with ``use_xyz`` (b, n, k, 3 + c), or
    the centred xyz without ``points``, idx (b, n, k) int32)."""
    idx = knn_indices(k * dilation + 1, xyz, xyz, impl=impl)[:, :, 1::dilation]
    grouped_xyz = group_point(xyz, idx) - xyz[:, :, None, :]
    if points is None:
        return grouped_xyz, grouped_xyz, idx
    grouped_points = group_point(points, idx)
    if use_xyz:
        grouped_points = torch.cat([grouped_xyz, grouped_points], dim=-1)
    return grouped_xyz, grouped_points, idx
