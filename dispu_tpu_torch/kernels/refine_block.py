"""The refiner's mega-fused block (``csrc/refine_block.cu``) and its plain
PyTorch version.

Replaces ``refine_block_pallas`` (``dispu_tpu/ops/pallas_kernels.py``),
which ``PointShuffle2`` reaches with ``local_impl='megafused'``: the exact
self-kNN of the coarse points (k ≤ 16; on the card ``knn.cu``'s launch
just before the block's), the neighbourhood gathers (xyz exact, features
rounded once to bf16) and the local + skip branches of
:mod:`dispu_tpu_torch.kernels.refine_local`, with no grouped tensor in
device memory.  Inference only, as in the JAX package:
:class:`RefineBlockFunction` raises in backward.  Its forward is the
custom op ``dispu_tpu_torch::refine_block``.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import (LAUNCHES, custom_op, forward_of,
                                     use_kernel)
from dispu_tpu_torch.kernels.knn import knn_cuda, knn_torch
from dispu_tpu_torch.kernels.knn_group import bf16_round, rows_at
from dispu_tpu_torch.kernels.refine_local import (LocalParams, cuda_args,
                                                  packed_scratch, param_dims,
                                                  refine_fake,
                                                  refine_local_torch,
                                                  tile_queries)

#: the most neighbours ``refine_block_pallas`` takes
MAX_K = 16
#: one block's shared memory on Hopper, and the weights' ring before the
#: tile's regions (``refine_common.cuh``: kStages = 2 buffers of
#: kStageBytes = 32 KB, 2 kStages mbarriers of 8 bytes, kStages ints
#: rounded up to 4)
MAX_SMEM = 232448
RING_BYTES = 2 * 32768 + 2 * 2 * 8 + 4 * 4

_P = ctypes.c_void_p
_I = ctypes.c_int


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _ld(c: int) -> int:
    """An mma operand's row stride: whole k8 blocks, = 4 mod 8."""
    return ((c + 7) & ~7) + 4


def block_smem(k: int, cf: int, c1: int, c2: int, c_out: int,
               tile: int) -> int:
    """Shared-memory bytes of one block of the kernel at these widths and
    ``tile`` queries a block, or 0 past a block's limit: the formula of
    ``csrc/refine_block.cu``'s ``dispu_refine_block_smem`` (the ring, the
    tile's indices, then ``tile_mlp``'s regions), so that the CPU can
    route without the library.  Neither n nor ``c_out`` enters it."""
    rows32 = (tile * k + 31) & ~31
    pool = 8 * _ld(k * c2)  # the other block's pool rows for the heads
    mlp = (max(rows32 * max(_ld(cf), _ld(c2)), pool)
           + max(rows32 * _ld(c1), pool) + _round4(rows32 * k)
           + 16 * _ld(cf))
    floats = _round4(tile * k) + mlp
    nbytes = RING_BYTES + 4 * floats
    return nbytes if nbytes <= MAX_SMEM else 0


def block_fits(k: int, cf: int, c1: int, c2: int, c_out: int) -> bool:
    """Whether the kernel takes k neighbours at these widths, for any n
    (at ``GeneratorConfig()`` width, k = 16, cf = 134: 222,512 bytes of
    shared memory a block)."""
    return k <= MAX_K and block_smem(k, cf, c1, c2, c_out,
                                     tile_queries(k)) > 0


def grouped_rows(xyz: torch.Tensor, feats: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """The megafused neighbourhoods ``[p − q | p | bf16(f_p)]`` (b, n, k,
    6 + c) at (b, n, k) indices."""
    gx = rows_at(xyz, idx)
    return torch.cat([gx - xyz[:, :, None, :], gx,
                      bf16_round(rows_at(feats, idx))], dim=-1)


def refine_block_torch(xyz: torch.Tensor, feats: torch.Tensor,
                       p: LocalParams,
                       idx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: :func:`knn_torch` of the points among themselves
    (unless ``idx`` gives the (b, n, k) selection), the gathers, the
    features rounded with :func:`bf16_round`, then
    :func:`refine_local_torch`."""
    if idx is None:
        _, idx = knn_torch(p.ww.shape[-1], xyz, xyz)
    return refine_local_torch(grouped_rows(xyz, feats, idx), p)


def _check(xyz, feats, p):
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or feats.dim() != 3 \
            or tuple(feats.shape[:2]) != tuple(xyz.shape[:2]):
        raise ValueError(f"refine_block takes xyz (b, n, 3) and feats (b, n, "
                         f"c), got {tuple(xyz.shape)} and "
                         f"{tuple(feats.shape)}")
    c, k = feats.shape[-1], p.ww.shape[-1]
    if p.w0.shape[0] != 6 + c or p.wsk.shape[0] != 6 + c:
        raise ValueError("w0/wsk rows must be [cen(3)|raw(3)|feat(c)]")
    if k > MAX_K:
        raise ValueError(f"refine_block supports k <= {MAX_K}, got {k}")
    if k > xyz.shape[1]:
        raise ValueError(f"k={k} exceeds n={xyz.shape[1]}")


def refine_block_cuda(xyz: torch.Tensor, feats: torch.Tensor,
                      p: LocalParams, with_idx: bool = False):
    """Launch the kernels: :func:`~dispu_tpu_torch.kernels.knn.knn_cuda`
    of the points among themselves (knn.cu's tiled stream, any n; its
    launch counted as a ``knn`` one), then ``refine_block.cu`` from those
    indices.  Same contract as :func:`refine_block_torch`; with
    ``with_idx`` also returns the (b, n, k) int32 selection.  Raises
    ``ValueError`` where a block's shared memory cannot hold the weights'
    ring and a tile at these widths."""
    from dispu_tpu_torch.kernels import _build

    _check(xyz, feats, p)
    for t in (xyz, feats):
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError("refine_block kernel takes float32 CUDA tensors")
    b, n, _ = xyz.shape
    c, k = feats.shape[-1], p.ww.shape[-1]
    cf = 6 + c
    c1, c2, c_out = param_dims(p, k, cf)
    dev = xyz.device
    xyz_c, feats_c = cuda_args((xyz, feats), dev)
    args = cuda_args(p, dev)
    lib = _build.load("refine_block")
    tile = tile_queries(k)
    lib.dispu_refine_block_smem.argtypes = [_I] * 6
    lib.dispu_refine_block_smem.restype = ctypes.c_size_t
    if lib.dispu_refine_block_smem(k, cf, c1, c2, c_out, tile) == 0:
        raise ValueError(
            f"refine_block kernel: a tile of {tile} queries at widths "
            f"({cf}, {c1}, {c2}, {c_out}) beside the weights' ring exceeds "
            "one block's 232,448 bytes of shared memory")
    packed = packed_scratch(lib, "dispu_refine_block", k, cf, c1, c2, c_out,
                            dev)
    _, idx = knn_cuda(k, xyz_c, xyz_c)
    out = torch.empty((b, n, c_out), dtype=torch.float32, device=dev)
    fn = lib.dispu_refine_block
    fn.argtypes = [_P] * 15 + [_I] * 8 + [_P]
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(xyz_c.data_ptr(), idx.data_ptr(), feats_c.data_ptr(),
                    *(a.data_ptr() for a in args), packed.data_ptr(),
                    out.data_ptr(), b, n, k, cf, c1, c2, c_out, tile, stream)
    _build.check(status, "refine_block kernel launch")
    LAUNCHES["refine_block"] += 1
    return (out, idx) if with_idx else out


def refine_block_op_torch(xyz: torch.Tensor, feats: torch.Tensor,
                          params: list[torch.Tensor]) -> torch.Tensor:
    """The op's CPU form: :func:`refine_block_torch`."""
    return refine_block_torch(xyz, feats, LocalParams(*params))


def refine_block_op_cuda(xyz, feats, params):
    """The op's CUDA form: :func:`refine_block_cuda`."""
    return refine_block_cuda(xyz, feats, LocalParams(*params))


refine_block_op = custom_op(
    "refine_block", refine_block_op_torch, refine_block_op_cuda,
    lambda xyz, feats, params: refine_fake(xyz, params))


class RefineBlockFunction(torch.autograd.Function):
    """The mega-fused block, forward by the kernel (``use_cuda``) or by
    :func:`refine_block_torch`, through the custom op
    (:func:`~dispu_tpu_torch.kernels.forward_of`).  No backward rule: the
    JAX package's kernel has none, and its training path keeps the
    composed form."""

    @staticmethod
    def forward(ctx, xyz, feats, use_cuda, *params):
        return forward_of(use_cuda, xyz, refine_block_op,
                          refine_block_op_cuda, refine_block_op_torch)(
                              xyz, feats, list(params))

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("refine_block is inference only, as in the JAX "
                           "package: train with the composed refiner")


def refine_block(xyz: torch.Tensor, feats: torch.Tensor, params: LocalParams,
                 impl: str = "auto") -> torch.Tensor:
    """xyz (b, n, 3), feats (b, n, c) → (b, n, c_out): each point's k =
    ``params.ww.shape[-1]`` ≤ 16 nearest points, grouped as ``[p − q | p |
    bf16(f_p)]``, through the refiner's local and skip branches.  The
    kernel for CUDA tensors, the plain version for CPU tensors; inference
    only (backward raises)."""
    _check(xyz, feats, params)
    return RefineBlockFunction.apply(xyz, feats, use_kernel(impl, xyz),
                                     *params)
