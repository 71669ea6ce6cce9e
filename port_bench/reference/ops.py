"""Plain point-set operations of the reference: distances, the kNN and
ball-query selections, farthest point sampling, gathers, normalization.

Each follows Dis-PU's published operation with the tie rules the
benchmarked program states for it: a kNN ranks by the expansion-form
squared distance ``(|q|² − 2q·p) + |p|²`` and breaks ties to the lower
index (a stable sort); FPS starts at index 0 from min-distances of 1e38,
updates them with ``((dx² + dy²) + dz²)`` and takes the first maximum; a
ball query keeps the first ``nsample`` points inside the radius in index
order, padded with the first.  Every selection runs :func:`uncounted`, so
that its arithmetic is no model FLOP.
"""

from __future__ import annotations

import torch

from port_bench.reference.flops import uncounted


def sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., n, c), (..., m, c) → (..., n, m): ``max((|x|² − 2x·y) + |y|²,
    0)``."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.matmul(x, y.transpose(-1, -2))
    return torch.clamp_min(x2 - 2.0 * xy + y2.transpose(-1, -2), 0.0)


def take(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (b, n, c) ``points`` at (b, m) indices → (b, m, c)."""
    idx = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, idx)


def group(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (b, n, c) ``points`` at (b, m, k) indices → (b, m, k, c)."""
    b, m, k = idx.shape
    return take(points, idx.reshape(b, m * k)).reshape(b, m, k, -1)


def duplicate_rows(points: torch.Tensor) -> torch.Tensor:
    """(b, n, c) → (b, n) bool: True where an identical row exists at a
    smaller index of the same cloud."""
    b, n, c = points.shape
    flat = points.reshape(-1, c)
    index = torch.arange(flat.shape[0], device=points.device)
    cloud = torch.div(index, n, rounding_mode="floor").to(points.dtype)
    _, grp = torch.unique(torch.cat([cloud[:, None], flat], dim=1), dim=0,
                          return_inverse=True)
    first = torch.full_like(index, flat.shape[0]).scatter_reduce_(
        0, grp, index, "amin")
    return (first[grp] != index).reshape(b, n)


def knn(k: int, points: torch.Tensor, queries: torch.Tensor,
        unique: bool = False) -> torch.Tensor:
    """(b, m, k) int64 indices of each query's k nearest points, nearest
    first, ties to the lower index; with ``unique`` rows that repeat an
    earlier row rank last (a column bias of 1e30)."""
    with uncounted(), torch.no_grad():
        points, queries = points.detach().float(), queries.detach().float()
        d = sq_dist(queries, points)
        if unique:
            d = d + duplicate_rows(points).float()[:, None, :] * 1e30
        return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def nearest(a: torch.Tensor, b: torch.Tensor, rows: int = 4096
            ) -> torch.Tensor:
    """(b, n) index of each ``a`` row's nearest ``b`` row (first minimum),
    in blocks of ``rows`` queries."""
    with uncounted(), torch.no_grad():
        out = [torch.argmin(sq_dist(a[:, i:i + rows].detach(), b.detach()),
                            dim=-1) for i in range(0, a.shape[1], rows)]
        return torch.cat(out, dim=1)


def nearest_exact(a: torch.Tensor, b: torch.Tensor, rows: int = 128
                  ) -> torch.Tensor:
    """(b, n) index of each ``a`` row's nearest ``b`` row by the direct
    squared distance ``Σ (a − b)²`` (first minimum), in blocks of ``rows``:
    an exact copy of a ``b`` row finds it, where the expansion form's
    round-off may prefer a neighbour a hair away."""
    with uncounted(), torch.no_grad():
        out = [torch.argmin(torch.sum(
            (a[:, i:i + rows, None, :] - b[:, None, :, :]) ** 2, dim=-1),
            dim=-1) for i in range(0, a.shape[1], rows)]
        return torch.cat(out, dim=1)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               queries: torch.Tensor, select_smallest: int = 0):
    """First ``nsample`` points of ``xyz`` with squared distance below
    ``radius²`` (f32) of each query, in index order, padded with the first
    hit (0 where none); with ``select_smallest`` the indices of that many
    nearest slots (a stable sort of the slots' distances) instead."""
    with uncounted(), torch.no_grad():
        b, n, _ = xyz.shape
        r2 = torch.tensor(radius, dtype=torch.float32,
                          device=xyz.device) ** 2
        d = sq_dist(queries.float(), xyz.float())
        hit = d < r2
        cols = torch.arange(n, device=xyz.device)
        key = torch.where(hit, cols, n)
        kk = min(nsample, n)
        slots = torch.sort(key, dim=-1).values[..., :kk]
        if kk < nsample:
            slots = torch.cat([slots, torch.full(
                slots.shape[:-1] + (nsample - kk,), n, dtype=slots.dtype,
                device=slots.device)], dim=-1)
        valid = slots < n
        any_hit = valid[..., :1]
        idx = torch.where(valid, slots, torch.where(any_hit, slots[..., :1],
                                                    0))
        if not select_smallest:
            return idx
        d_sel = torch.gather(d, -1, torch.where(valid, slots, 0))
        dists = torch.where(valid, d_sel,
                            torch.where(any_hit, d_sel[..., :1], 0.0))
        order = torch.sort(dists, dim=-1, stable=True).indices
        return torch.gather(idx, -1, order[..., :select_smallest])


def min_dist_update(xyz: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Squared distances ``((dx² + dy²) + dz²)`` of every (b, n, 3) point
    to the (b, m) points ``last`` → (b, m, n)."""
    p = take(xyz, last)                                     # (b, m, 3)
    d = xyz[:, None, :, :] - p[:, :, None, :]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def fps(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Farthest point sampling, one round at a time: (b, n, 3) → (b,
    npoint) int64, the first pick index 0."""
    with uncounted(), torch.no_grad():
        b, n, _ = xyz.shape
        mind = torch.full((b, n), 1e38, dtype=torch.float32,
                          device=xyz.device)
        out = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
        last = torch.zeros((b, 1), dtype=torch.int64, device=xyz.device)
        for j in range(1, npoint):
            mind = torch.minimum(mind, min_dist_update(xyz, last)[:, 0])
            last = torch.argmax(mind, dim=1, keepdim=True)
            out[:, j:j + 1] = last
        return out


def fps_rounds_off(xyz: torch.Tensor, picks: torch.Tensor,
                   block: int = 256) -> int:
    """How many of the (b, m) ``picks`` are not the pick that farthest
    point sampling of (b, n, 3) ``xyz`` makes after the picks before them:
    pick j must be the first maximum of the min-distance of every point to
    picks 0..j−1 (pick 0 must be index 0).  Computed ``block`` rounds at a
    time from the running min-distance, so that it gives the bits of
    :func:`fps` round by round without its thousands of sequential
    steps; 0 exactly when ``picks`` is FPS's output."""
    with uncounted(), torch.no_grad():
        b, n, _ = xyz.shape
        picks = picks.long()
        off = int((picks[:, 0] != 0).sum())
        mind = torch.full((b, n), 1e38, dtype=torch.float32,
                          device=xyz.device)
        m = picks.shape[1]
        for lo in range(0, m - 1, block):
            hi = min(lo + block, m - 1)
            d = min_dist_update(xyz, picks[:, lo:hi])       # (b, r, n)
            run = torch.minimum(torch.cummin(d, dim=1).values,
                                mind[:, None, :])
            chosen = torch.argmax(run, dim=2)               # (b, r)
            off += int((chosen != picks[:, lo + 1:hi + 1]).sum())
            mind = run[:, -1]
        return off


def normalize(pc: torch.Tensor):
    """(b, n, 3) → (centred / furthest, centroid (b, 1, 3), furthest (b, 1,
    1)), the scale floored at 1e-12."""
    centroid = torch.mean(pc, dim=1, keepdim=True)
    centred = pc - centroid
    furthest = torch.amax(torch.sqrt(torch.sum(centred ** 2, dim=-1,
                                               keepdim=True)),
                          dim=1, keepdim=True)
    return centred / torch.clamp_min(furthest, 1e-12), centroid, furthest
