"""Patch dataset: the PU-GAN HDF5 file or a procedural stand-in
(counterpart of ``data/dataset.py``, numpy throughout).

In ``random_input`` mode the input column equals the dense gt patch and
the train step draws the sparse input from it; gt is normalized to the
unit sphere, the input shares that normalization, and the radius is 1.
Every full batch is visited once an epoch, in an order shuffled by a
numpy ``RandomState`` seeded as the JAX package seeds it, so both packages
see the same batches.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


def normalize_point_cloud_np(pc: np.ndarray):
    """Center (b, n, 3) clouds on their centroids and scale them by their
    furthest point: (normalized, centroid, furthest)."""
    centroid = np.mean(pc, axis=1, keepdims=True)
    centered = pc - centroid
    furthest = np.amax(
        np.sqrt(np.sum(centered ** 2, axis=-1, keepdims=True)), axis=1,
        keepdims=True,
    )
    return centered / furthest, centroid, furthest


def load_h5_data(h5_filename: str, in_num: int, out_num: int,
                 random: bool = True, normalized: bool = True):
    """(inputs, gt, radius) from a PU-GAN HDF5 file: ``random`` mode reads
    the dense ``poisson_<out_num>`` column for both; gt is normalized and
    the input takes gt's centroid and scale; the radius is all ones.
    Needs ``h5py``, imported here."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("load_h5_data needs the h5py package") from e

    with h5py.File(h5_filename, "r") as f:
        inputs = f["poisson_%d" % (out_num if random else in_num)][:]
        gt = f["poisson_%d" % out_num][:]
    if len(inputs) != len(gt):
        raise ValueError(f"{h5_filename}: {len(inputs)} inputs but "
                         f"{len(gt)} gt patches")
    radius = np.ones(len(inputs), np.float32)
    if normalized:
        gt, centroid, furthest = normalize_point_cloud_np(gt)
        inputs = (inputs - centroid) / furthest
    return inputs.astype(np.float32), gt.astype(np.float32), radius


def synthetic_patches(n_patches: int, n_points: int, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Procedural patches for runs without the HDF5 file: random height
    fields (a quadric base, a sharp crease at a random angle and a
    mid-frequency relief) normalized to the unit sphere.  Bit-equal to the
    JAX package's ``synthetic_patches`` for the same arguments."""
    rng = np.random.RandomState(seed)
    gt = np.empty((n_patches, n_points, 3), np.float32)
    for i in range(n_patches):
        uv = rng.rand(n_points, 2) * 2.0 - 1.0
        a, b, c = rng.randn(3) * 0.5
        z = a * uv[:, 0] ** 2 + b * uv[:, 1] ** 2 + c * uv[:, 0] * uv[:, 1]
        theta = rng.rand() * np.pi
        t = uv[:, 0] * np.cos(theta) + uv[:, 1] * np.sin(theta)
        z += rng.uniform(0.2, 0.6) * np.abs(t)
        fu, fv = rng.uniform(2.0, 4.0, size=2)
        phase = rng.rand(2) * 2 * np.pi
        z += rng.uniform(0.05, 0.15) * np.sin(
            fu * np.pi * uv[:, 0] + phase[0]
        ) * np.sin(fv * np.pi * uv[:, 1] + phase[1])
        gt[i] = np.stack([uv[:, 0], uv[:, 1], z], axis=-1)
    gt, _, _ = normalize_point_cloud_np(gt)
    radius = np.ones(n_patches, np.float32)
    return gt.copy(), gt, radius


class PatchDataset:
    """In-memory patch set with shuffled full-batch iteration."""

    def __init__(self, data_dir: str = "data", num_point: int = 256,
                 up_ratio: int = 4, random_input: bool = True,
                 h5_path: Optional[str] = None,
                 synthetic_patches_count: int = 0, seed: int = 0):
        self.num_point = num_point
        self.up_ratio = up_ratio
        self.random_input = random_input
        out_num = num_point * up_ratio
        path = h5_path or os.path.join(
            data_dir, "PUGAN_poisson_%d_poisson_%d.h5" % (num_point, out_num))
        if os.path.exists(path):
            self.inputs, self.gt, self.radius = load_h5_data(
                path, num_point, out_num, random=random_input)
        elif synthetic_patches_count:
            self.inputs, self.gt, self.radius = synthetic_patches(
                synthetic_patches_count, out_num, seed=seed)
        else:
            raise FileNotFoundError(
                f"no dataset at {path}; pass synthetic_patches_count for a "
                "procedural stand-in")
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.gt)

    def num_batches(self, batch_size: int) -> int:
        return len(self.gt) // batch_size

    def epoch_indices(self, batch_size: int, shuffle: bool = True
                      ) -> Iterator[np.ndarray]:
        """Each full batch's patch indices, in a shuffled order."""
        order = np.arange(len(self.gt))
        if shuffle:
            self._rng.shuffle(order)
        for b in range(self.num_batches(batch_size)):
            yield order[b * batch_size:(b + 1) * batch_size]
