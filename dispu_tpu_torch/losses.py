"""Losses of CD and GAN training (counterpart of ``losses.py``): Chamfer,
Hausdorff, the approximate EMD, repulsion, the uniformity statistic, the
LSGAN critic and generator losses, the composite ``pu_losses`` and the
epoch schedules; and the reference's variants that no training path
calls: the exact disk uniformity metric (host numpy on FPS seeds), the
geometric triplet, L1 and cross entropy, the RBF repulsion
(``repulsion4``), ``perulsion_loss``, the unnormalised Chamfer
``cd_loss2`` and the kNN spacing variance ``uniform_knn``.

Every loss takes ``impl`` for the kernels it reaches (the chamfer argmin's
kNN kernel and the ball-query kernel; see ``dispu_tpu_torch.kernels``).
Where the JAX package ranks with ``lax.top_k``, the port takes a stable
sort, which orders ties by index as ``top_k`` does, so the same neighbour
receives the gradient.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from dispu_tpu_torch.ops.chamfer import nn_distance
from dispu_tpu_torch.ops.emd import earth_mover_cost
from dispu_tpu_torch.ops.grouping import group_point, query_ball_point
from dispu_tpu_torch.ops.geometry import pairwise_sq_dist
from dispu_tpu_torch.ops.knn import knn, knn_indices
from dispu_tpu_torch.ops.sampling import farthest_point_sample, gather_point


#: the approximate EMD (``ops/emd.py``), under the JAX package's name
earth_mover = earth_mover_cost


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest values of each row, ascending, ties by index
    (``-top_k(-x, k)`` of the JAX package)."""
    return torch.sort(x, dim=-1, stable=True).values[..., :k]


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``maximum(0, x)`` with JAX's gradient at 0 (half to each side)."""
    return torch.maximum(x, x.new_zeros(()))


def chamfer(pred: torch.Tensor, gt: torch.Tensor, radius=1.0,
            forward_weight: float = 1.0, threshold: float | None = None,
            impl: str = "auto") -> torch.Tensor:
    """Mean symmetric Chamfer loss: each direction's nearest squared
    distance (distances above ``mean·threshold`` zeroed when a threshold is
    given), per-direction means summed, divided by the radius, averaged
    over the batch."""
    dists_forward, _, dists_backward, _ = nn_distance(gt, pred, impl)
    if threshold is not None:
        fwd = torch.mean(dists_forward, dim=1, keepdim=True) * threshold
        bwd = torch.mean(dists_backward, dim=1, keepdim=True) * threshold
        dists_forward = torch.where(dists_forward < fwd, dists_forward, 0.0)
        dists_backward = torch.where(dists_backward < bwd, dists_backward,
                                     0.0)
    cd = (forward_weight * torch.mean(dists_forward, dim=1)
          + torch.mean(dists_backward, dim=1))
    return torch.mean(cd / radius)


def hausdorff(pred: torch.Tensor, gt: torch.Tensor, radius=1.0,
              forward_weight: float = 1.0, threshold: float | None = None,
              impl: str = "auto") -> torch.Tensor:
    """Hausdorff-style loss: each direction's largest nearest squared
    distance (those at or above ``threshold`` zeroed when given), summed,
    divided by the radius, then the maximum over the batch."""
    dists_forward, _, dists_backward, _ = nn_distance(gt, pred, impl)
    if threshold is not None:
        dists_forward = torch.where(dists_forward < threshold, dists_forward,
                                    0.0)
        dists_backward = torch.where(dists_backward < threshold,
                                     dists_backward, 0.0)
    hd = (forward_weight * torch.amax(dists_forward, dim=1)
          + torch.amax(dists_backward, dim=1))
    return torch.amax(hd / radius)


def repulsion(pred: torch.Tensor, nsample: int = 20, radius: float = 0.07,
              use_knn: bool = False, use_l1: bool = False, h: float = 0.001,
              impl: str = "auto") -> torch.Tensor:
    """Push points apart when closer than ``sqrt(h)``: the 5 nearest of
    ``nsample`` neighbours (a ball query, padded with the first hit, or a
    kNN), the self column dropped, ``mean(max(0, h − d))``.  ``use_l1``
    takes L1 distances and ``h = 2·√h``.

    The default L2 ball path lets the ball query choose the 5 nearest
    (``select_smallest=5``, in the kernel on the card) and re-evaluates
    exact, differentiable ``|p − q|²`` on those 5 only, as the JAX package
    does."""
    if use_knn:
        idx = knn_indices(nsample, pred, pred, impl=impl)
        grouped = group_point(pred, idx) - pred[:, :, None, :]
        dists = (torch.sum(torch.abs(grouped), dim=-1) if use_l1
                 else torch.sum(grouped ** 2, dim=-1))
        val = -_smallest(dists, 5)[:, :, 1:]  # drop the nearest (self)
    elif use_l1:
        idx, _ = query_ball_point(radius, nsample, pred, pred, impl=impl)
        grouped = group_point(pred, idx) - pred[:, :, None, :]
        dists = torch.sum(torch.abs(grouped), dim=-1)
        val = -_smallest(dists, 5)[:, :, 1:]
    else:
        _, _, idx5 = query_ball_point(radius, nsample, pred, pred,
                                      select_smallest=5, impl=impl)
        grouped = group_point(pred, idx5) - pred[:, :, None, :]
        dists5 = torch.sum(grouped ** 2, dim=-1)  # exact, differentiable
        val = -dists5[:, :, 1:]  # drop the nearest (self)
    if use_l1:
        h = math.sqrt(h) * 2
    return torch.mean(_relu(h + val))


def uniform(pcd: torch.Tensor,
            percentages: Sequence[float] = (0.004, 0.006, 0.008, 0.010,
                                            0.012),
            radius: float = 1.0, impl: str = "auto") -> torch.Tensor:
    """NN-spacing uniformity statistic inside euclidean disks: FPS seeds
    (5% of the points), a ball of area fraction p around each, each
    member's exact squared distance to its nearest other member (chosen by
    a kNN at k = 2), compared with the ideal square-packing spacing,
    χ²-normalized and scaled by (100p)²."""
    _, n, _ = pcd.shape
    npoint = int(n * 0.05)
    seeds = gather_point(
        pcd, farthest_point_sample(npoint, pcd.detach(), impl=impl))
    loss = []
    for p in percentages:
        nsample = max(int(n * p), 2)
        r = math.sqrt(p * radius)
        disk_area = math.pi * (radius ** 2) * p / nsample
        expect_len = math.sqrt(disk_area)
        idx, _ = query_ball_point(r, nsample, pcd, seeds, impl=impl)
        disks = group_point(pcd, idx)  # (b, npoint, nsample, 3)
        b = disks.shape[0]
        flat = disks.reshape(b * npoint, nsample, 3)
        nn_idx = knn_indices(2, flat, flat, impl=impl)
        nbr = gather_point(flat, nn_idx[:, :, 1])
        d_exact = torch.sum((flat - nbr) ** 2, dim=-1)
        spacing = torch.sqrt(torch.abs(d_exact + 1e-8))
        dev = (spacing - expect_len) ** 2 / (expect_len + 1e-8)
        loss.append(torch.mean(dev) * (p * 100) ** 2)
    return sum(loss) / len(percentages)


def uniform_exact(pcd, percentages: Sequence[float] = (
        0.002, 0.004, 0.006, 0.008, 0.010, 0.012, 0.015),
                  radius: float = 1.0, cap_counts: bool = False,
                  impl: str = "auto") -> float:
    """Exact disk-uniformity metric (the reference's 'whole, slower'
    variant; no gradient).  ``pcd`` (b, n, 3), a tensor (on the card or
    the CPU) or an array.  The 5% seeds come from
    :func:`farthest_point_sample` on the tensor's device; the rest is host
    numpy, as in the JAX package: per disk of area fraction p, coverage
    ``(count − nsample)² / nsample``, and from 5 members on, times the
    χ²-normalised deviation of each member's nearest-member spacing from
    the hexagonal ideal.

    Membership is every point strictly inside the radius, so an overdense
    disk (count > nsample) is penalised; ``cap_counts=True`` keeps only
    the first ``nsample`` members, as the reference's CUDA ball query
    does."""
    pts_t = torch.as_tensor(pcd)
    b, n, _ = pts_t.shape
    npoint = int(n * 0.05)
    seeds_idx = farthest_point_sample(npoint, pts_t.detach(),
                                      impl=impl).cpu().numpy()
    pcd = pts_t.detach().cpu().numpy()
    total = []
    for p in percentages:
        nsample = max(int(n * p), 1)
        r = math.sqrt(p * radius)
        vals = []
        for i in range(b):
            pts = pcd[i]
            seeds = pts[seeds_idx[i]]
            # strict d < r with the CUDA op's 1e-20 floor
            d = np.sqrt(np.maximum(
                np.sum((seeds[:, None] - pts[None]) ** 2, -1), 1e-40))
            inside = d < r  # (npoint, n)
            for j in range(npoint):
                members = np.nonzero(inside[j])[0]
                number = len(members)
                if cap_counts and number > nsample:
                    members = members[:nsample]
                    number = nsample
                coverage = (number - nsample) ** 2 / nsample
                if number < 5:
                    vals.append(coverage)
                    continue
                disk = pts[members]
                dd = np.sum((disk[:, None] - disk[None]) ** 2, -1)
                np.fill_diagonal(dd, np.inf)
                shortest = np.sqrt(dd.min(axis=1))
                disk_area = math.pi * (r ** 2) / disk.shape[0]
                expect_d = math.sqrt(2 * disk_area / 1.732)  # hexagon
                dis = (shortest - expect_d) ** 2 / expect_d
                vals.append(coverage * float(np.mean(dis)))
        total.append(float(np.mean(vals)) * math.sqrt(p * 100))
    return sum(total) / len(percentages)


def geometric_losses(pred: torch.Tensor, gt: torch.Tensor, nnk: int = 8):
    """(shape, density, direction): the symmetric mean nearest euclidean
    distance; the mean absolute difference of the gt→pred and gt→gt
    ``nnk`` nearest-distance spectra; their normalised correlation."""
    d = torch.sqrt(torch.clamp_min(pairwise_sq_dist(gt, pred), 1e-12))
    shape = (torch.mean(torch.amin(d, dim=2))
             + torch.mean(torch.amin(d, dim=1)))
    d2 = torch.sqrt(torch.clamp_min(pairwise_sq_dist(gt, gt), 1e-12))
    k1, k2 = -_smallest(d, nnk), -_smallest(d2, nnk)
    density = torch.mean(torch.abs(k1 - k2))
    gt_off = k2 / (torch.sum(k2 ** 2) + 1e-8)
    pt_off = k1 / (torch.sum(k1 ** 2) + 1e-8)
    return shape, density, torch.sum(gt_off * pt_off)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``mean(|x − y|)``."""
    return torch.mean(torch.abs(x - y))


def classify_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sparse softmax cross entropy: ``−mean(log_softmax(logits)[label])``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[..., None]))


# ---------------------------------------------------------------- GAN (LSGAN)


def discriminator_loss(d_real: torch.Tensor,
                       d_fake: torch.Tensor) -> torch.Tensor:
    """``0.5·(mean((D(real) − 1)²) + mean(D(fake)²))``."""
    return 0.5 * (torch.mean((d_real - 1.0) ** 2) + torch.mean(d_fake ** 2))


def generator_loss(d_fake: torch.Tensor) -> torch.Tensor:
    """``mean((D(fake) − 1)²)``."""
    return torch.mean((d_fake - 1.0) ** 2)


# ------------------------------------------------------------------ schedules


def weight_fine_schedule(epoch: float,
                         boundaries: Sequence[float] = (10.0, 20.0, 30.0),
                         values: Sequence[float] = (0.01, 0.1, 0.5, 1.0)
                         ) -> float:
    """Piecewise-constant fine-loss weight: ``values[i]`` for
    ``boundaries[i-1] < epoch <= boundaries[i]``, as an f32 value."""
    bounds = torch.tensor(boundaries, dtype=torch.float32)
    at = torch.tensor(epoch, dtype=torch.float32)
    i = int(torch.searchsorted(bounds, at, side="left"))
    return float(torch.tensor(values, dtype=torch.float32)[i])


def lr_schedule(epoch: float, base_lr: float = 1e-3,
                decay_step_epochs: int = 30, decay_rate: float = 0.7,
                clip: float = 1e-6) -> float:
    """Staircase exponential decay over epochs, clipped below, as an f32
    value: ``max(base_lr · decay_rate^floor(epoch / step), clip)``.

    The power is PyTorch's f32 ``pow``; XLA's may differ from it in the
    last bit at some exponents (it is 1 exactly for the first
    ``decay_step_epochs`` epochs)."""
    f32 = torch.float32
    k = torch.floor(torch.tensor(epoch, dtype=f32) / decay_step_epochs)
    factor = torch.tensor(decay_rate, dtype=f32) ** k
    return float(torch.maximum(base_lr * factor, torch.tensor(clip, dtype=f32)))


# -------------------------------------------------- composite training losses


def pu_losses(coarse: torch.Tensor, fine: torch.Tensor, gt: torch.Tensor,
              radius, weight_fine: float, loss_cfg, impl: str = "auto"
              ) -> Tuple[torch.Tensor, dict]:
    """The CD-path total generator loss, ``1000·CD(coarse) +
    w_fine·1000·CD(fine) + repulsion``, and its metrics (the Hausdorff
    terms are tracked, not added; ``offset_mean``/``offset_max`` measure
    how far the refiner moves the points)."""
    coarse_cd = loss_cfg.coarse_cd_w * chamfer(coarse, gt, radius, impl=impl)
    fine_cd = loss_cfg.fine_cd_w * chamfer(fine, gt, radius, impl=impl)
    coarse_hd = loss_cfg.hd_w * hausdorff(coarse, gt, radius, impl=impl)
    fine_hd = loss_cfg.hd_w * hausdorff(fine, gt, radius, impl=impl)
    if loss_cfg.use_repulsion:
        rep = loss_cfg.repulsion_w * repulsion(
            fine, nsample=loss_cfg.repulsion_nsample,
            radius=loss_cfg.repulsion_radius, h=loss_cfg.repulsion_h,
            impl=impl)
    else:
        rep = fine.new_zeros(())
    total = coarse_cd + weight_fine * fine_cd + rep
    off = torch.sqrt(torch.sum((fine - coarse) ** 2, dim=-1) + 1e-20)
    metrics = {
        "coarse_cd": coarse_cd,
        "fine_cd": fine_cd,
        "coarse_hd": coarse_hd,
        "fine_hd": fine_hd,
        "repulsion": rep,
        "weight_fine": weight_fine,
        "offset_mean": torch.mean(off),
        "offset_max": torch.amax(off),
    }
    return total, metrics


def repulsion4(pred: torch.Tensor, nsample: int = 20, radius: float = 0.07,
               impl: str = "auto") -> torch.Tensor:
    """RBF-weighted spacing penalty (the PU-Net-style 'uniform loss'): the
    ball query's ``nsample`` neighbours, the 5 nearest squared distances
    less the self column (floored at 1e-12), h = 0.03,
    ``mean(radius − d·exp(−d²/h²))``."""
    idx, _ = query_ball_point(radius, nsample, pred, pred, impl=impl)
    grouped = group_point(pred, idx) - pred[:, :, None, :]
    d2 = _smallest(torch.sum(grouped ** 2, dim=-1), 5)[:, :, 1:]
    d2 = torch.maximum(d2, d2.new_tensor(1e-12))
    h = 0.03
    return torch.mean(radius - torch.sqrt(d2) * torch.exp(-d2 / h ** 2))


def perulsion_loss(pred: torch.Tensor, nsample: int = 15,
                   radius: float = 0.07, use_knn: bool = False,
                   use_l1: bool = False, impl: str = "auto") -> torch.Tensor:
    """Repulsion with an L1/L2 switch: kNN or ball neighbourhoods, the 4
    nearest non-self squared (or, with ``use_l1``, euclidean) distances,
    h = 2√0.001 (L1) or 0.01 (L2), ``mean(max(0, h − d))``."""
    if use_knn:
        idx = knn_indices(nsample, pred, pred, impl=impl)
    else:
        idx, _ = query_ball_point(radius, nsample, pred, pred, impl=impl)
    grouped = group_point(pred, idx) - pred[:, :, None, :]
    dists = torch.sum(grouped ** 2, dim=-1)
    if use_l1:
        dists = torch.sqrt(dists + 1e-12)
    val = -_smallest(dists, 5)[:, :, 1:]
    h = math.sqrt(0.001) * 2 if use_l1 else 0.01
    return torch.mean(_relu(h + val))


#: the reference's spelling
get_perulsion_loss = perulsion_loss


def cd_loss2(pred: torch.Tensor, gt: torch.Tensor,
             forward_weight: float = 1.0, threshold: float | None = 100.0,
             impl: str = "auto") -> torch.Tensor:
    """:func:`chamfer` at radius 1 with an outlier threshold of 100× each
    cloud's mean by default."""
    return chamfer(pred, gt, radius=1.0, forward_weight=forward_weight,
                   threshold=threshold, impl=impl)


def uniform_knn(pred: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Variance of kNN spacing: the 6 nearest squared distances (self
    included); the variance over the points of each point's mean, plus
    each point's variance over its 6, summed over the batch."""
    d, _ = knn(6, pred, pred, impl=impl)
    mean = torch.mean(d, dim=2)
    return (torch.sum(torch.var(mean, dim=1, correction=0))
            + torch.sum(torch.var(d, dim=2, correction=0)))
