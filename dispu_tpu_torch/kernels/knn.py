"""kNN kernels (``csrc/knn.cu``) and their plain PyTorch versions.

Replaces ``knn_pallas`` (``dispu_tpu/ops/pallas_kernels.py``): the exact
selection (:func:`knn`, count ``LAUNCHES["knn"]``, and past the radix
form's shared memory ``LAUNCHES["knn_split"]``) and the packed-key turbo
selection of ``variant="packed"`` (:func:`knn_packed`, count
``LAUNCHES["knn_packed"]``).  For k <= :data:`MAX_STREAM_K` both kernels
stream each cloud through shared memory in coalesced tiles, with a
register tile of queries by points a thread, and keep each query's k best
in registers (any n); they are bound by the distances' f32 FMAs and the
selection's compares.  Beyond that k the exact selection is a radix
select, one block a query row (:func:`radix_plan`): digit passes over the
(distance, index) composites find the k-th, then the k are collected and
sorted.  Up to :data:`RADIX_ROW_POINTS` points the row's distances stay
in shared memory ('row', :func:`knn_cuda`, which takes n + c <=
:data:`RADIX_ROW_FLOATS`); past them each pass recomputes them from the
cloud (:func:`knn_split_cuda`), at any n.
:func:`knn_kernel_cuda` picks by shape (:func:`knn_form`).  The packed
selection past k = 32 keeps one warp a row and k rounds over the row
(n + c <= :data:`MAX_ROW_FLOATS`).  See the note at the top of the
source.  :func:`knn` is differentiable through :class:`KnnFunction`,
which carries ``knn_pallas_diff``'s backward rule in torch ops; so is
:func:`knn_packed`, by the same rule.  Both selections are custom ops,
``dispu_tpu_torch::knn`` (the shape gate of :func:`knn_kernel_cuda`
included) and ``dispu_tpu_torch::knn_packed``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dispu_tpu_torch.kernels import (LAUNCHES, custom_op, forward_of,
                                     use_kernel)
from dispu_tpu_torch.ops.geometry import pairwise_sq_dist
from dispu_tpu_torch.utils.tracing import add_syncs

#: the largest k of the tiled form, which takes any n
MAX_STREAM_K = 32
#: one block's shared memory on Hopper (232,448 bytes), in floats: the
#: packed selection's row form past k = 32 holds one query's distance row
#: plus the query there (``knn_group``'s row form the same)
MAX_ROW_FLOATS = 232448 // 4
#: the radix form's words ahead of the query: a histogram of 256 bins and
#: 16 words of control (``kRadixHead``)
RADIX_HEAD_WORDS = 256 + 16
#: the radix form's 'row' regime keeps a query's n distances beside the
#: query and the head: n + c <= RADIX_ROW_FLOATS (57,840)
RADIX_ROW_FLOATS = MAX_ROW_FLOATS - RADIX_HEAD_WORDS
#: the most points at which :func:`knn_form` takes the 'row' regime: past
#: them the 'split' regime, which recomputes the distances, took no more
#: device time at k 256 and c 3, 24 to 703 queries (``time_knn_forms
#: --regimes``)
RADIX_ROW_POINTS = 4096
#: the 'split' regime's buffer: the tied group of the descent is taken into
#: shared memory once it holds at most this many entries
RADIX_CAP = 4096
#: threads of a radix block at most (``kRadixMaxThreads``)
RADIX_MAX_THREADS = 1024
#: rows from which the 'split' regime takes blocks of 512 threads: two
#: blocks of 1024 on each of an H100's 132 SMs (on the 60,000-point cut,
#: 703 rows, 512 threads took 0.486 ms against 0.528 at 1024)
RADIX_SPLIT_ROWS = 2 * 132

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


def _check(k, points, queries, bias, row_floats=None):
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
    if row_floats is not None and n + c > row_floats:
        raise ValueError(
            f"knn kernel at k={k} holds a query's n + c = {n + c} floats in "
            f"shared memory; the limit is {row_floats}"
        )


def knn_form(k: int, n: int, c: int) -> str:
    """The exact kernel's form for k neighbours among n points of c
    coordinates: 'tiled' (k <= :data:`MAX_STREAM_K`, any n), else the
    radix form's 'row' regime (at most :data:`RADIX_ROW_POINTS` points,
    the row in a block's shared memory beside the head, n + c <=
    :data:`RADIX_ROW_FLOATS`) or its 'split' regime."""
    if k <= MAX_STREAM_K:
        return "tiled"
    return ("row" if n <= RADIX_ROW_POINTS and n + c <= RADIX_ROW_FLOATS
            else "split")


def radix_threads(n: int, form: str, rows: int) -> int:
    """Threads of a radix block for ``rows`` query rows of n points: in
    the 'row' regime the power of two nearest above n / 4, from a warp to
    :data:`RADIX_MAX_THREADS` (64 at 256 points, 512 at 2,048); in the
    'split' regime, whose passes sweep the whole cloud, 512 where the rows
    fill the card (:data:`RADIX_SPLIT_ROWS`), else the most."""
    if form == "split":
        return 512 if rows >= RADIX_SPLIT_ROWS else RADIX_MAX_THREADS
    t = 32
    while t < RADIX_MAX_THREADS and 4 * t < n:
        t *= 2
    return t


def radix_smem(k: int, row_words: int, c: int) -> tuple[int, bool]:
    """(bytes of dynamic shared memory, whether the k pairs sort there) of
    a radix block holding ``row_words`` words of row: the 'row' regime's n
    distances or the 'split' regime's buffer of 2 · cap words; (0, False)
    where the row does not fit.  ``radix_smem`` in the source."""
    base = RADIX_HEAD_WORDS + c + row_words
    if base > MAX_ROW_FLOATS:
        return 0, False
    if base + 2 * k <= MAX_ROW_FLOATS:
        return 4 * (base + 2 * k), True
    return 4 * base, False


class RadixPlan(NamedTuple):
    """A radix launch: its regime (:func:`knn_form`), threads a block,
    dynamic shared memory in bytes, whether the k pairs sort in shared
    memory (else in the output rows), and the 'split' buffer's pairs (0
    for 'row')."""
    form: str
    threads: int
    smem: int
    out_smem: bool
    cap: int


@functools.lru_cache(maxsize=256)
def radix_plan(k: int, n: int, c: int, rows: int, form: str | None = None,
               cap: int | None = None) -> RadixPlan:
    """The radix launch for ``rows`` query rows of k > :data:`MAX_STREAM_K`
    neighbours among n points of c coordinates, in ``form`` (by default
    :func:`knn_form`'s) and for 'split' with a buffer of ``cap`` pairs
    (default :data:`RADIX_CAP`); raises ``ValueError`` where it does not
    fit."""
    form = knn_form(k, n, c) if form is None else form
    if form == "row":
        smem, out = radix_smem(k, n, c)
        cap = 0
    elif form == "split":
        cap = RADIX_CAP if cap is None else cap
        if cap < 1:
            raise ValueError(f"knn split form: cap={cap} must be >= 1")
        smem, out = radix_smem(k, 2 * cap, c)
    else:
        raise ValueError(f"no radix regime {form!r} (k={k}, n={n})")
    if not smem:
        raise ValueError(
            f"knn radix form ({form}) at k={k}, n={n}, c={c}: the row and "
            f"the query must fit {MAX_ROW_FLOATS} floats of shared memory")
    return RadixPlan(form, radix_threads(n, form, rows), smem, out, cap)


def knn_kernel_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
                    bias: torch.Tensor | None = None):
    """The exact selection on the card: :func:`knn_split_cuda` exactly
    where :func:`knn_form` says 'split', else :func:`knn_cuda`.  A shape
    gate: both return the same bits wherever both run."""
    if points.dim() == 3 and knn_form(k, *points.shape[1:]) == "split":
        return knn_split_cuda(k, points, queries, bias)
    return knn_cuda(k, points, queries, bias)


def _launch(name, argtypes, what, points, *args):
    """Call entry ``name`` of ``csrc/knn.cu`` (built on first use) on
    ``points``' device and current stream; raise on a CUDA error."""
    from dispu_tpu_torch.kernels import _build

    fn = getattr(_build.load("knn"), name)
    fn.argtypes = argtypes
    fn.restype = _I
    with torch.cuda.device(points.device):
        status = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(status, what)


def _outputs(k, points, queries):
    b, m = queries.shape[:2]
    return (torch.empty((b, m, k), dtype=torch.float32, device=points.device),
            torch.empty((b, m, k), dtype=torch.int32, device=points.device))


def knn_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
             bias: torch.Tensor | None = None):
    """Launch the kernel: the tiled form, or past k = 32 the radix form's
    'row' regime.  Same contract as :func:`knn_torch`; raises
    ``ValueError`` past the 'row' regime's n."""
    row = k > MAX_STREAM_K
    _check(k, points, queries, bias, RADIX_ROW_FLOATS if row else None)
    b, n, c = points.shape
    m = queries.shape[1]
    threads = radix_plan(k, n, c, b * m, "row").threads if row else 0
    if bias is None and not row:  # the tiled form reads a bias
        bias = torch.zeros((b, n), dtype=torch.float32, device=points.device)
    dists, idx = _outputs(k, points, queries)
    _launch("dispu_knn", [_P] * 5 + [_I] * 6 + [_P], "knn kernel launch",
            points, points.data_ptr(), queries.data_ptr(),
            0 if bias is None else bias.data_ptr(), dists.data_ptr(),
            idx.data_ptr(), b, n, m, c, k, threads)
    LAUNCHES["knn"] += 1
    return dists, idx


def knn_split_cuda(k: int, points: torch.Tensor, queries: torch.Tensor,
                   bias: torch.Tensor | None = None, cap: int | None = None):
    """Launch the radix form's 'split' regime (the distances recomputed
    from the cloud each pass, the tied group taken into a buffer of
    ``cap`` pairs, by default :data:`RADIX_CAP`) at any n and any k >= 1:
    the 'row' regime's bits.  Same contract as :func:`knn_torch`."""
    _check(k, points, queries, bias)
    b, n, c = points.shape
    m = queries.shape[1]
    plan = radix_plan(k, n, c, b * m, "split", cap)
    dists, idx = _outputs(k, points, queries)
    _launch("dispu_knn_split", [_P] * 5 + [_I] * 7 + [_P],
            "knn split kernel launch", points, points.data_ptr(),
            queries.data_ptr(), 0 if bias is None else bias.data_ptr(),
            dists.data_ptr(), idx.data_ptr(), b, n, m, c, k, plan.threads,
            plan.cap)
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


#: the host's waits in ``torch.unique(dim=0)`` on a CUDA tensor that torch's
#: sync debug mode does not see: its Thrust algorithms each synchronize
#: the stream (6 ``cudaStreamSynchronize`` calls a call with torch 2.11
#: and CUDA 12.8 on an H100, by the profiler); the tracer counts them here
UNIQUE_DIM_SYNCS = 6


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
    if points.is_cuda:
        add_syncs(UNIQUE_DIM_SYNCS)
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
    _check(k, points, queries, bias,
           MAX_ROW_FLOATS if k > MAX_STREAM_K else None)
    b, n, c = points.shape
    m = queries.shape[1]
    if bias is None:
        bias = torch.zeros((b, n), dtype=torch.float32, device=points.device)
    dists, idx = _outputs(k, points, queries)
    _launch("dispu_knn_packed", [_P] * 5 + [_I] * 6 + [_P],
            "packed knn kernel launch", points, points.data_ptr(),
            queries.data_ptr(), bias.data_ptr(), dists.data_ptr(),
            idx.data_ptr(), b, n, m, c, k, packed_lane_bits(n))
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
