"""Patch extraction from whole clouds, for training and for testing
(counterpart of ``ops/patches.py``).

Seeds (farthest points, or one drawn point a cloud), the k nearest points
around each, and the patch axis folded into the batch axis.  On the card
the seeds come from the FPS kernel and the patches from the kNN kernel.
The test path first drops outliers, points whose nearest other point lies
at 5× the cloud's mean or more; that count depends on the data, so the
filter runs on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dispu_tpu_torch.ops.knn import knn
from dispu_tpu_torch.ops.sampling import farthest_point_sample, gather_point


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(b, s, k, c) → (s·b, k, c), patch-major: every cloud's patch 0,
    then every cloud's patch 1, …"""
    return x.transpose(0, 1).reshape(-1, *x.shape[2:])


def _rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of (b, n, c) ``points`` at (b, s, k) indices → (b, s, k, c)."""
    b, s, k = idx.shape
    return gather_point(points, idx.reshape(b, s * k)).reshape(
        b, s, k, points.shape[-1])


def extract_patches_train(batch_xyz: torch.Tensor, k: int,
                          patch_num: int = 1,
                          batch_features: Optional[torch.Tensor] = None,
                          gt_xyz: Optional[torch.Tensor] = None,
                          gt_k: Optional[int] = None,
                          generator: Optional[torch.Generator] = None,
                          impl: str = "auto"):
    """Seeded kNN patches of (b, n, 3) clouds → (patches (patch_num·b, k,
    3), feature patches or None, gt patches or None), patch-major.

    ``patch_num`` > 1 seeds by FPS; ``patch_num`` == 1 draws one seed a
    cloud uniformly from ``generator`` (required then, on the clouds'
    device).  ``gt_xyz`` with ``gt_k`` also cuts the ``gt_k`` nearest
    ground-truth points around the same seeds."""
    b, n, _ = batch_xyz.shape
    if patch_num > 1:
        seeds = gather_point(batch_xyz, farthest_point_sample(
            patch_num, batch_xyz, impl=impl))
    else:
        if generator is None:
            raise ValueError("patch_num == 1 requires a generator")
        idx = torch.randint(0, n, (b, 1), generator=generator,
                            device=batch_xyz.device)
        seeds = gather_point(batch_xyz, idx)
    _, patch_idx = knn(k, batch_xyz, seeds, impl=impl)
    feats = gts = None
    if batch_features is not None:
        feats = _fold(_rows(batch_features, patch_idx))
    if gt_xyz is not None and gt_k is not None:
        _, gt_idx = knn(gt_k, gt_xyz, seeds, impl=impl)
        gts = _fold(_rows(gt_xyz, gt_idx))
    return _fold(_rows(batch_xyz, patch_idx)), feats, gts


def extract_patches_test(xyz: np.ndarray, k: int, seed_factor: int = 5,
                         device="cuda", impl: str = "auto"
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Outlier-filtered, FPS-seeded patches of one (n, 3) cloud → (patches
    (patch_num, k', 3), seeds (patch_num, 3)), numpy, with patch_num =
    int(n / k · seed_factor) and k' = min(k, points kept).  The kNN and
    FPS run on ``device`` ('cuda' by default)."""
    from dispu_tpu_torch.inference import resolve_device

    dev = resolve_device(device)
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    pts = torch.from_numpy(xyz).to(dev)[None]
    d2, _ = knn(2, pts, pts, impl=impl)
    closest = d2[0, :, 1].cpu().numpy()
    filtered = xyz[closest < 5.0 * closest.mean()]
    kept = torch.from_numpy(filtered).to(dev)[None]
    patch_num = int(n / k * seed_factor)
    seed_idx = farthest_point_sample(patch_num, kept, impl=impl)
    seeds = gather_point(kept, seed_idx)
    _, idx = knn(min(k, filtered.shape[0]), kept, seeds, impl=impl)
    return filtered[idx[0].cpu().numpy()], seeds[0].cpu().numpy()
