"""Ball-query kernel (``csrc/query_ball.cu``) and its plain PyTorch version.

Replaces ``query_ball_pallas`` (``dispu_tpu/ops/pallas_kernels.py``): the
first ``nsample`` dataset points, in index order, strictly inside a radius
(scalar or one per cloud) of each query; empty slots repeat the first hit
(index 0 for an empty ball); counts capped at ``nsample``; optionally each
slot's squared distance (pad slots repeat the first hit's, an empty ball
gives 0) and the indices of the ``select_smallest`` nearest slots, ties to
the lower slot.  Indices and distances carry no gradient.  On an H100 the
kernel is bound by its scan of the points (one warp a query, stopping at
the ``nsample``-th hit); see the note at the top of the source.
"""

from __future__ import annotations

import ctypes

import torch

from dispu_tpu_torch.kernels import LAUNCHES, use_kernel
from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

#: what the kernel takes (the JAX package's gate for its Pallas kernel)
MAX_N = 4096
MAX_C = 128
MAX_NSAMPLE = 128

_P = ctypes.c_void_p
_I = ctypes.c_int


def radius_sq(radius, b: int, device) -> torch.Tensor:
    """(b,) f32 squared radii from a scalar or a (b,) radius, squared in
    f32 as the JAX package does."""
    r = torch.as_tensor(radius, dtype=torch.float32, device=device).detach()
    return torch.broadcast_to(r, (b,)).contiguous() ** 2


def query_ball_torch(radius, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor, return_dists: bool = False,
                     select_smallest: int = 0):
    """Plain version: the XLA twin of the JAX package (``grouping.py``).

    Hit keys ``where(d < r², j, n)`` sorted ascending give the first hits
    in index order; ``select_smallest`` takes a *stable* sort of the padded
    distances, since ``torch.topk`` does not pin the order of ties and
    ``lax.top_k`` takes the lower slot first.  Returns (idx (b, m,
    nsample) int32, cnt (b, m) int32[, dists (b, m, nsample) f32][, sel
    (b, m, select_smallest) int32]).
    """
    b, n, _ = xyz.shape
    r2 = radius_sq(radius, b, xyz.device)
    d = pairwise_sq_dist(new_xyz, xyz)                       # (b, m, n)
    hit = d < r2[:, None, None]
    cols = torch.arange(n, device=xyz.device)
    key = torch.where(hit, cols, n)
    k_eff = min(nsample, n)
    slots = torch.sort(key, dim=-1).values[..., :k_eff]
    if k_eff < nsample:
        slots = torch.cat([slots, torch.full(
            slots.shape[:-1] + (nsample - k_eff,), n, dtype=slots.dtype,
            device=slots.device)], dim=-1)
    valid = slots < n
    any_hit = valid[..., :1]
    pad = torch.where(any_hit, slots[..., :1], 0)
    idx = torch.where(valid, slots, pad).to(torch.int32)
    cnt = torch.clamp_max(hit.sum(dim=-1), nsample).to(torch.int32)
    if not (return_dists or select_smallest):
        return idx, cnt
    d_sel = torch.gather(d, -1, torch.where(valid, slots, 0))
    dists = torch.where(valid, d_sel,
                        torch.where(any_hit, d_sel[..., :1], 0.0))
    extras = [dists] if return_dists else []
    if select_smallest:
        order = torch.sort(dists, dim=-1, stable=True).indices
        extras.append(torch.gather(idx, -1, order[..., :select_smallest]))
    return (idx, cnt, *extras)


def _check(nsample, xyz, new_xyz, select_smallest):
    if xyz.dim() != 3 or new_xyz.dim() != 3:
        raise ValueError("ball-query kernel takes (b, n, c) points and "
                         "(b, m, c) queries")
    b, n, c = xyz.shape
    if new_xyz.shape[0] != b or new_xyz.shape[2] != c:
        raise ValueError(f"queries {tuple(new_xyz.shape)} do not match "
                         f"points {tuple(xyz.shape)}")
    for t in (xyz, new_xyz):
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError("ball-query kernel takes contiguous float32 "
                             "CUDA tensors")
        if t.device != xyz.device:
            raise ValueError("ball-query kernel inputs lie on different "
                             "devices")
    if not (1 <= n <= MAX_N and 1 <= c <= MAX_C
            and 1 <= nsample <= MAX_NSAMPLE and new_xyz.shape[1] >= 1):
        raise ValueError(
            f"ball-query kernel takes n <= {MAX_N}, c <= {MAX_C} and "
            f"nsample <= {MAX_NSAMPLE}; got n={n}, c={c}, nsample={nsample}")
    if not 0 <= select_smallest <= nsample:
        raise ValueError(f"select_smallest={select_smallest} exceeds "
                         f"nsample={nsample}")


def query_ball_cuda(radius, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor, return_dists: bool = False,
                    select_smallest: int = 0):
    """Launch the kernel.  Same contract as :func:`query_ball_torch`, up to
    the rounding of the distances (the kernel sums q·p in FMAs)."""
    from dispu_tpu_torch.kernels import _build

    _check(nsample, xyz, new_xyz, select_smallest)
    b, n, c = xyz.shape
    m = new_xyz.shape[1]
    dev = xyz.device
    r2 = radius_sq(radius, b, dev)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=dev)
    cnt = torch.empty((b, m), dtype=torch.int32, device=dev)
    dists = (torch.empty((b, m, nsample), dtype=torch.float32, device=dev)
             if return_dists else None)
    sel = (torch.empty((b, m, select_smallest), dtype=torch.int32,
                       device=dev) if select_smallest else None)
    fn = _build.load("query_ball").dispu_query_ball
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(xyz.data_ptr(), new_xyz.data_ptr(), r2.data_ptr(),
                    idx.data_ptr(), cnt.data_ptr(),
                    dists.data_ptr() if dists is not None else None,
                    sel.data_ptr() if sel is not None else None,
                    b, n, m, c, nsample, select_smallest, stream)
    _build.check(status, "ball-query kernel launch")
    LAUNCHES["query_ball"] += 1
    extras = [t for t in (dists, sel) if t is not None]
    return (idx, cnt, *extras)


def query_ball(radius, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               return_dists: bool = False, select_smallest: int = 0,
               impl: str = "auto"):
    """The kernel for CUDA tensors, the plain version for CPU tensors (see
    :func:`dispu_tpu_torch.kernels.use_kernel`)."""
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    if use_kernel(impl, xyz):
        return query_ball_cuda(radius, nsample, xyz.contiguous(),
                               new_xyz.contiguous(), return_dists,
                               select_smallest)
    return query_ball_torch(radius, nsample, xyz, new_xyz, return_dists,
                            select_smallest)
