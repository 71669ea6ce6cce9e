"""Whole-cloud evaluation with the queries sharded over the mesh
(counterpart of ``parallel/sharded_eval.py``).

Each process takes its slice of each cloud's points as queries against
the whole opposite cloud; only two sums and two maxima cross processes.
"""

from __future__ import annotations

import torch

from dispu_tpu_torch.ops.geometry import pairwise_sq_dist
from dispu_tpu_torch.parallel.mesh import (all_reduce_max_, all_reduce_sum_,
                                           data_size, local_rows)


def _directed(queries: torch.Tensor, cloud: torch.Tensor) -> torch.Tensor:
    """Each query's squared distance to its nearest point of ``cloud``,
    chosen by the expanded distances and measured exactly."""
    idx = torch.argmin(pairwise_sq_dist(queries[None], cloud[None])[0],
                       dim=-1)
    return torch.sum((queries - cloud[idx]) ** 2, dim=-1)


def sharded_cd_hd(mesh, pred: torch.Tensor, gt: torch.Tensor):
    """Chamfer and Hausdorff of two (n, 3) clouds with the queries sharded
    over the mesh: (cd, hd) 0-d tensors, the definitions of
    ``evaluation.metrics.cd_hd`` without its normalization.

    Each cloud is padded to a multiple of the data axis by repeating its
    first point; the pad rows are masked out of the sums and maxima, so
    the result is exact.  Every process gets both values."""
    w = data_size(mesh)

    def reduced(queries, cloud):
        n = queries.shape[0]
        pad = (-n) % w
        if pad:
            queries = torch.cat([queries, queries[:1].expand(pad, 3)])
        mine = local_rows(mesh, queries.shape[0])
        dist = _directed(queries[mine], cloud)
        valid = torch.arange(mine.start, mine.stop,
                             device=dist.device) < n
        total = torch.sum(torch.where(valid, dist, 0.0))
        top = torch.amax(torch.where(valid, dist, -torch.inf))
        return total, top

    fwd_sum, fwd_max = reduced(pred, gt)
    bwd_sum, bwd_max = reduced(gt, pred)
    sums = torch.stack([fwd_sum, bwd_sum])
    maxima = torch.stack([fwd_max, bwd_max])
    all_reduce_sum_([sums], mesh)
    all_reduce_max_([maxima], mesh)
    cd = sums[0] / pred.shape[0] + sums[1] / gt.shape[0]
    hd = maxima[0] + maxima[1]
    return cd, hd
