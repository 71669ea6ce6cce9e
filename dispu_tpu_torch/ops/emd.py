"""Approximate Earth Mover's Distance (counterpart of ``ops/emd.py``).

The soft match of the reference's ``approxmatch`` op: 10 temperature
rounds (level −4^j for j = 7 … −2, then 0), each normalizing a soft
assignment against the rows' and the columns' remaining capacity, with
the op's C-style integer multiplicities and its 1e-9 guards.  Every round
is two dense (n, m) contractions, so it is plain torch on any device, as
the JAX package computes it in XLA and not in Pallas.
"""

from __future__ import annotations

import torch

from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

_LEVELS = tuple(float(-(4.0 ** j)) for j in range(7, -2, -1)) + (0.0,)


@torch.no_grad()
def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """(b, n, 3) and (b, m, 3) clouds → the (b, m, n) soft match: entry
    [l, k] is the mass moved between ``xyz2[l]`` and ``xyz1[k]``, rows and
    columns within the multiplicities ``max(1, m // n)`` and ``max(1, n //
    m)`` (integer division, as in C).  It carries no gradient."""
    xyz1, xyz2 = xyz1.float(), xyz2.float()
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    mult_l = 1.0 if n >= m else float(m // n)
    mult_r = float(n // m) if n >= m else 1.0
    d = pairwise_sq_dist(xyz1, xyz2)  # (b, n, m)
    remain_l = torch.full((b, n), mult_l, dtype=torch.float32,
                          device=xyz1.device)
    remain_r = torch.full((b, m), mult_r, dtype=torch.float32,
                          device=xyz1.device)
    match = torch.zeros((b, m, n), dtype=torch.float32, device=xyz1.device)
    for level in _LEVELS:
        kern = torch.exp(level * d)  # underflows to 0 when cold
        # row normalization against the columns' remaining capacity
        suml = 1e-9 + torch.einsum("bnm,bm->bn", kern, remain_r)
        ratio_l = remain_l / suml
        # column consumption, clamped to the remaining capacity
        sumr = torch.einsum("bnm,bn->bm", kern, ratio_l) * remain_r
        consumption = torch.clamp_max(remain_r / (sumr + 1e-9), 1.0)
        ratio_r = consumption * remain_r
        remain_r = torch.clamp_min(remain_r - sumr, 0.0)
        # commit the mass, deplete the rows' capacity
        w = kern * ratio_l[:, :, None] * ratio_r[:, None, :]
        match = match + w.transpose(1, 2)
        remain_l = torch.clamp_min(remain_l - torch.sum(w, dim=2), 0.0)
    return match


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor,
               match: torch.Tensor) -> torch.Tensor:
    """(b,) transport cost of ``match`` (b, m, n): the sum of euclidean
    distance × moved mass.  The gradient flows through the distances with
    the match held fixed; the square root is taken of at least 1e-20, so
    coincident points get a gradient of 0."""
    d = pairwise_sq_dist(xyz1, xyz2)  # (b, n, m)
    dist = torch.sqrt(torch.clamp_min(d, 1e-20))
    return torch.einsum("bnm,bmn->b", dist, match.detach())


def earth_mover_cost(pcd1: torch.Tensor, pcd2: torch.Tensor,
                     radius=1.0) -> torch.Tensor:
    """The mean over clouds of the per-point approximate EMD, divided by
    ``radius`` (a scalar or (b,)); both clouds hold the same number of
    points."""
    if pcd1.shape[1] != pcd2.shape[1]:
        raise ValueError("EMD expects equal point counts, got "
                         f"{pcd1.shape[1]} and {pcd2.shape[1]}")
    match = approx_match(pcd1, pcd2)
    cost = match_cost(pcd1, pcd2, match) / radius
    return torch.mean(cost / float(pcd1.shape[1]))
