"""Neighbourhood gathers (counterpart of ``ops/grouping.py``).

Every exact gather of the JAX package ('gather', and the one-hot MXU
contractions 'onehot_hp', 'onehot3' and 'pallas', which it proves
bit-identical to a gather) is one plain index gather here: on the card a
load is exact, so the TPU's one-hot detour has no reason to exist.  The
ball query runs the ball-query kernel on the card where the JAX package's
gate admits its Pallas kernel.
"""

from __future__ import annotations

import torch

from dispu_tpu_torch.config import EXACT_GATHERS
from dispu_tpu_torch.kernels import IMPLS
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


def group_point(points: torch.Tensor, idx: torch.Tensor,
                impl: str = "gather") -> torch.Tensor:
    """(b, n, c) points, (b, m, k) indices → (b, m, k, c)."""
    if impl not in EXACT_GATHERS:
        raise NotImplementedError(
            f"group_point impl={impl!r} is not ported yet (ROADMAP.md, "
            "queue 1: turbo and opt-in paths)"
        )
    b, m, k = idx.shape
    c = points.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(b, m * k, c)
    return torch.gather(points, 1, flat).reshape(b, m, k, c)


def grouping(feature: torch.Tensor, k: int, src_xyz: torch.Tensor,
             q_xyz: torch.Tensor, use_xyz: bool = True, use_knn: bool = True,
             radius: float = 0.2, gather_impl: str = "gather",
             impl: str = "auto"):
    """kNN (or, with ``use_knn=False``, ball) neighbourhoods of the query
    points with their gathered features.

    Returns (grouped_xyz (b, m, k, 3), grouped_feature (b, m, k, 3 + c or
    c), idx (b, m, k)).  One combined ``[xyz | feature]`` gather, as on the
    JAX package's exact path.
    """
    if use_knn:
        idx = knn_indices(k, src_xyz, q_xyz, impl=impl)
    else:
        idx, _ = query_ball_point(radius, k, src_xyz, q_xyz, impl=impl)
    combined = group_point(torch.cat([src_xyz, feature], dim=-1), idx,
                           impl=gather_impl)
    grouped_xyz = combined[..., :3]
    grouped_feature = combined if use_xyz else combined[..., 3:]
    return grouped_xyz, grouped_feature, idx
