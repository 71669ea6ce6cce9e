"""kNN kernels (``csrc/knn.cu``) and their plain PyTorch versions.

Replaces ``knn_pallas`` (``dispu_tpu/ops/pallas_kernels.py``): the exact
selection (:func:`knn`, count ``LAUNCHES["knn"]``, and past the row form's
n ``LAUNCHES["knn_split"]``) and the packed-key turbo selection of
``variant="packed"`` (:func:`knn_packed`, count ``LAUNCHES["knn_packed"]``).
For k <= :data:`MAX_STREAM_K` both kernels stream each cloud through
shared memory in coalesced tiles, with a register tile of queries by
points a thread, and keep each query's k best in registers (any n); they
are bound by the distances' f32 FMAs and the selection's compares.  Beyond
that k one warp per query keeps the query's distance row in shared memory
and takes k rounds over it (n + c <= :data:`MAX_ROW_FLOATS`); past that n
the exact selection splits the row into chunks (:func:`knn_split_cuda`),
which :func:`knn_kernel_cuda` picks by shape.  See the note at the top of
the source.  :func:`knn` is differentiable through :class:`KnnFunction`,
which carries ``knn_pallas_diff``'s backward rule in torch ops; so is
:func:`knn_packed`, by the same rule.  Both selections are custom ops,
``dispu_tpu_torch::knn`` (the shape gate of :func:`knn_kernel_cuda`
included) and ``dispu_tpu_torch::knn_packed``.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import (LAUNCHES, custom_op, forward_of,
                                     use_kernel)
from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

#: the largest k of the tiled form, which takes any n
MAX_STREAM_K = 32
#: beyond it the row form's one query's distance row plus the query, in
#: floats, must fit one block's shared memory (232,448 bytes on Hopper);
#: so must the split form's chunk rows and its merge's candidate row
MAX_ROW_FLOATS = 232448 // 4
#: warps a block of the row forms holds at most (``kMaxWarps``)
ROW_WARPS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def knn_torch(k: int, points: torch.Tensor, queries: torch.Tensor,
              bias: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the full distance matrix, then a stable sort.

    ``torch.topk`` does not pin the order of ties; the stable sort gives
    the lexicographic (distance, index) order of ``lax.top_k`` and of the
    kernels.  Returns ((b, m, k) f32 ascending, (b, m, k) int32).
    """
    d = pairwise_sq_dist(queries, points)
    if bias is not None:
        d = d + bias[..., None, :]
    d, idx = torch.sort(d, dim=-1, stable=True)
    return d[..., :k].contiguous(), idx[..., :k].to(torch.int32).contiguous()


def _check(k, points, queries, bias, row_form):
    if points.dim() != 3 or queries.dim() != 3:
        raise ValueError("knn kernel takes (b, n, c) points and (b, m, c) "
                         "queries")
    b, n, c = points.shape
    if queries.shape[0] != b or queries.shape[2] != c:
        raise ValueError(f"queries {tuple(queries.shape)} do not match "
                         f"points {tuple(points.shape)}")
    tensors = [points, queries] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("knn kernel takes contiguous float32 CUDA "
                             "tensors")
        if t.device != points.device:
            raise ValueError("knn kernel inputs lie on different devices")
    if bias is not None and tuple(bias.shape) != (b, n):
        raise ValueError(f"bias must be (b, n) = {(b, n)}")
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, n={n}]")
    if row_form and n + c > MAX_ROW_FLOATS:
        raise ValueError(
            f"knn kernel at k={k} holds a query's n + c = {n + c} floats in "
            f"shared memory; the limit is {MAX_ROW_FLOATS}"
        )


def knn_form(k: int, n: int, c: int) -> str:
    """The exact kernel's form for k neighbours among n points of c
    coordinates: 'tiled' (k <= :data:`MAX_STREAM_K`, any n), 'row' (the
    row fits a block's shared memory) or 'split'."""
    if k <= MAX_STREAM_K:
        return "tiled"
    return "row" if n + c <= MAX_ROW_FLOATS else "split"


def split_chunk(c: int) -> int:
    """The split form's chunk of points: as many, in multiples of 32, as
    let :data:`ROW_WARPS` rows of chunk + c floats fill one block's
    shared memory (7,232 at c = 3)."""
    return max(32, (MAX_ROW_FLOATS // ROW_WARPS - c) // 32 * 32)


def split_plan(k: int, n: int, c: int, chunk: int | None = None):
    """(chunk, chunks) of the split form; raises ``ValueError`` where a
    chunk's row or the merge's row of k · chunks candidates does not fit
    one block's shared memory."""
    chunk = split_chunk(c) if chunk is None else chunk
    chunks = -(-n // chunk)
    if chunk < 1 or chunk + c > MAX_ROW_FLOATS \
            or k * chunks > MAX_ROW_FLOATS:
        raise ValueError(
            f"knn split form at k={k}, n={n}, c={c}: chunks of {chunk} + c "
            f"floats and the merge's {k} x {chunks} candidates must each "
            f"fit {MAX_ROW_FLOATS} floats of shared memory")
    return chunk, chunks


def knn_kernel_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
                    bias: torch.Tensor | None = None):
    """The exact selection on the card: :func:`knn_split_cuda` exactly
    where :func:`knn_form` says the row form does not fit, else
    :func:`knn_cuda`.  A shape gate: both return the same bits wherever
    both run."""
    if points.dim() == 3 and knn_form(k, *points.shape[1:]) == "split":
        return knn_split_cuda(k, points, queries, bias)
    return knn_cuda(k, points, queries, bias)


def knn_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
             bias: torch.Tensor | None = None):
    """Launch the kernel (the tiled or the row form).  Same contract as
    :func:`knn_torch`; raises ``ValueError`` past the row form's n."""
    from dispu_tpu_torch.kernels import _build

    _check(k, points, queries, bias, row_form=k > MAX_STREAM_K)
    b, n, c = points.shape
    m = queries.shape[1]
    if bias is None:
        bias = torch.zeros((b, n), dtype=torch.float32, device=points.device)
    dists = torch.empty((b, m, k), dtype=torch.float32, device=points.device)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=points.device)
    fn = _build.load("knn").dispu_knn
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(points.data_ptr(), queries.data_ptr(), bias.data_ptr(),
                    dists.data_ptr(), idx.data_ptr(), b, n, m, c, k, stream)
    _build.check(status, "knn kernel launch")
    LAUNCHES["knn"] += 1
    return dists, idx


def knn_split_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
                   bias: torch.Tensor | None = None,
                   chunk: int | None = None):
    """Launch the split row form (``chunk`` points a chunk, by default
    :func:`split_chunk`): the row form's bits at any n that
    :func:`split_plan` admits.  Same contract as :func:`knn_torch`."""
    from dispu_tpu_torch.kernels import _build

    _check(k, points, queries, bias, row_form=False)
    b, n, c = points.shape
    m = queries.shape[1]
    chunk, chunks = split_plan(k, n, c, chunk)
    dev = points.device
    if bias is None:
        bias = torch.zeros((b, n), dtype=torch.float32, device=dev)
    cand_d = torch.empty((b * m * chunks * k,), dtype=torch.float32,
                         device=dev)
    cand_j = torch.empty((b * m * chunks * k,), dtype=torch.int32,
                         device=dev)
    dists = torch.empty((b, m, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dev)
    fn = _build.load("knn").dispu_knn_split
    fn.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(points.data_ptr(), queries.data_ptr(), bias.data_ptr(),
                    cand_d.data_ptr(), cand_j.data_ptr(), dists.data_ptr(),
                    idx.data_ptr(), b, n, m, c, k, chunk, stream)
    _build.check(status, "knn split kernel launch")
    LAUNCHES["knn_split"] += 1
    return dists, idx


def knn_backward(points: torch.Tensor, queries: torch.Tensor,
                 idx: torch.Tensor, g_dist: torch.Tensor):
    """``_knn_diff_bwd`` of the JAX package: the selection held fixed, the
    distance cotangent gives ``2·g·(q − p)`` to each query and its
    negation, scatter-added, to each chosen neighbour.  Returns
    (d_points (b, n, c), d_queries (b, m, c))."""
    b, m, k = idx.shape
    c = points.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(b, m * k, c)
    neighbors = torch.gather(points, 1, flat).reshape(b, m, k, c)
    contrib = 2.0 * g_dist[..., None] * (queries[:, :, None, :] - neighbors)
    d_queries = torch.sum(contrib, dim=2)
    d_points = torch.zeros_like(points).scatter_add_(
        1, flat, -contrib.reshape(b, m * k, c))
    return d_points, d_queries


def knn_fake(k, points, queries, bias=None):
    """The selections' shapes: ((b, m, k) f32, (b, m, k) int32)."""
    b, m = queries.shape[:2]
    return (queries.new_empty((b, m, k)),
            queries.new_empty((b, m, k), dtype=torch.int32))


knn_op = custom_op("knn", knn_torch, knn_kernel_cuda, knn_fake)


class KnnFunction(torch.autograd.Function):
    """kNN whose distances are differentiable in the points and queries:
    forward by the kernel (``use_cuda``) or by its plain version, through
    the custom op (:func:`~dispu_tpu_torch.kernels.forward_of`), the
    exact selection or with ``packed`` the packed one; backward by
    :func:`knn_backward` for both, the selection held fixed, as
    ``knn_pallas_diff`` does for every variant.  Indices and the bias
    carry no gradient."""

    @staticmethod
    def forward(ctx, k, points, queries, bias, use_cuda, packed=False):
        if packed:
            run = forward_of(use_cuda, points, knn_packed_op,
                             knn_packed_cuda, knn_packed_torch)
        else:
            run = forward_of(use_cuda, points, knn_op, knn_kernel_cuda,
                             knn_torch)
        dists, idx = run(k, points, queries, bias)
        ctx.save_for_backward(points, queries, idx)
        ctx.mark_non_differentiable(idx)
        return dists, idx

    @staticmethod
    def backward(ctx, g_dist, _g_idx):
        points, queries, idx = ctx.saved_tensors
        d_points, d_queries = knn_backward(points, queries, idx, g_dist)
        return None, d_points, d_queries, None, None, None


def knn(k: int, points: torch.Tensor, queries: torch.Tensor,
        bias: torch.Tensor | None = None, impl: str = "auto"):
    """k nearest ``points`` of each query, ascending, with an optional
    (b, n) column bias.  The kernel for CUDA tensors, the plain version
    for CPU tensors (see :func:`dispu_tpu_torch.kernels.use_kernel`);
    differentiable in ``points`` and ``queries``."""
    return KnnFunction.apply(k, points, queries, bias,
                             use_kernel(impl, points), False)


def duplicate_rows_torch(points: torch.Tensor) -> torch.Tensor:
    """(..., n, c) → (..., n) bool: True where an identical row exists at a
    smaller index of the same cloud (rows of finite values; -0.0 equals
    0.0): the columns that the duplicate bias of ``knn_unique`` sorts last.

    One lexicographic sort groups identical rows (``torch.unique`` over
    rows, with the cloud's index as a leading column, exact below 2²⁴
    clouds); a row is marked unless it has the smallest index of its
    group.  No (..., n, n) plane is formed."""
    n, c = points.shape[-2:]
    flat = points.reshape(-1, c)
    index = torch.arange(flat.shape[0], device=points.device)
    cloud = torch.div(index, n, rounding_mode="floor").to(points.dtype)
    _, group = torch.unique(torch.cat([cloud[:, None], flat], dim=1), dim=0,
                            return_inverse=True)
    first = torch.full_like(index, flat.shape[0]).scatter_reduce_(
        0, group, index, "amin")
    return (first[group] != index).reshape(points.shape[:-1])


# plain torch on every device, an op so that an exported graph holds it as
# one node: traced, ``torch.unique``'s output size is data-dependent, and
# some torch releases' shape-only form of it gives the inverse a float type
duplicate_rows_op = torch.library.custom_op(
    "dispu_tpu_torch::duplicate_rows", duplicate_rows_torch, mutates_args=())
duplicate_rows_op.register_fake(
    lambda points: points.new_empty(points.shape[:-1], dtype=torch.bool))


# ----------------------------------------------------- packed-key variant


def packed_lane_bits(n: int) -> int:
    """The packed selection's index bits for an n-point row: those of
    ``knn_pallas``'s padded row, ``n_pad = round_up(max(n, 128), 128)``,
    so the truncation of the distances is the TPU kernel's."""
    n_pad = -(-max(n, 128) // 128) * 128
    return max(1, (n_pad - 1).bit_length())


def knn_packed_torch(k: int, points: torch.Tensor, queries: torch.Tensor,
                     bias: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the packed (turbo) selection: the distance matrix
    of :func:`knn_torch`, each entry's bits with the low
    :func:`packed_lane_bits` bits replaced by its column index, and the k
    smallest of these distinct int keys ascending.  Returns ((b, m, k)
    truncated distances, (b, m, k) int32 indices)."""
    n = points.shape[1]
    lmask = (1 << packed_lane_bits(n)) - 1
    d = pairwise_sq_dist(queries, points)
    if bias is not None:
        d = d + bias[..., None, :]
    cols = torch.arange(n, dtype=torch.int32, device=d.device)
    keys = (d.contiguous().view(torch.int32) & ~lmask) | cols
    keys = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    return ((keys & ~lmask).view(torch.float32).contiguous(),
            (keys & lmask).contiguous())


def knn_packed_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
                    bias: torch.Tensor | None = None):
    """Launch the packed kernel.  Same contract as
    :func:`knn_packed_torch`; the tiled form for k <= ``MAX_STREAM_K``,
    beyond it the row form, which refuses n + c > ``MAX_ROW_FLOATS``."""
    from dispu_tpu_torch.kernels import _build

    _check(k, points, queries, bias, row_form=k > MAX_STREAM_K)
    b, n, c = points.shape
    m = queries.shape[1]
    if bias is None:
        bias = torch.zeros((b, n), dtype=torch.float32, device=points.device)
    dists = torch.empty((b, m, k), dtype=torch.float32, device=points.device)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=points.device)
    fn = _build.load("knn").dispu_knn_packed
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(points.data_ptr(), queries.data_ptr(), bias.data_ptr(),
                    dists.data_ptr(), idx.data_ptr(), b, n, m, c, k,
                    packed_lane_bits(n), stream)
    _build.check(status, "packed knn kernel launch")
    LAUNCHES["knn_packed"] += 1
    return dists, idx


knn_packed_op = custom_op("knn_packed", knn_packed_torch, knn_packed_cuda,
                          knn_fake)


def knn_packed(k: int, points: torch.Tensor, queries: torch.Tensor,
               bias: torch.Tensor | None = None, impl: str = "auto"):
    """The packed (turbo) selection of ``knn_pallas(variant='packed')``:
    near-ties whose distances agree above the low lane bits resolve by
    index, and the distances come back truncated.  The kernel for CUDA
    tensors, the plain version for CPU tensors.  The truncated distances
    carry ``knn_pallas_diff``'s fixed-selection gradient in ``points``
    and ``queries`` (:class:`KnnFunction`), the exact selection's rule."""
    return KnnFunction.apply(k, points, queries,
                             None if bias is None else bias.detach(),
                             use_kernel(impl, points), True)
