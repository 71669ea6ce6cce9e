"""Per-step input draw and augmentation on the step's device (counterpart of
``data/augment.py``).

Each function draws from a ``torch.Generator`` and hands its draws to an
inner ``*_from`` function that does the arithmetic, so a test can feed both
packages the same numbers: PyTorch's and JAX's generators differ.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from dispu_tpu_torch.ops.sampling import (gather_point, gumbel,
                                          nonuniform_indices_from)


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    """(b,) angles → (b, 3, 3) rotations about z, applied on the right
    (``points @ R``)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], dim=-2)


def _top(keys: torch.Tensor, k: int, largest: bool) -> torch.Tensor:
    """Indices of the k largest (or smallest) keys of each row, ties to the
    lower index as ``lax.top_k`` orders them."""
    return torch.sort(keys, dim=-1, descending=largest, stable=True
                      ).indices[..., :k]


def sample_nonuniform_inputs_from(gt: torch.Tensor, num_out: int,
                                  loc_u: torch.Tensor,
                                  noise: torch.Tensor) -> torch.Tensor:
    """Gaussian-biased subsample of each dense (b, n, 3) patch, given the
    draws (``loc_u`` (b,) uniform, ``noise`` (b, n) Gumbel)."""
    return gather_point(gt, nonuniform_indices_from(loc_u, noise, num_out))


def sample_nonuniform_inputs(gt: torch.Tensor, num_out: int,
                             generator: torch.Generator) -> torch.Tensor:
    """(b, n, 3) dense patches → (b, num_out, 3) Gaussian-biased
    subsamples (the reference's ``random`` input mode)."""
    b, n, _ = gt.shape
    loc_u = torch.rand((b,), generator=generator, device=gt.device)
    noise = gumbel((b, n), generator, gt.device)
    return sample_nonuniform_inputs_from(gt, num_out, loc_u, noise)


def sample_cluster_inputs_from(gt: torch.Tensor, num_out: int,
                               cluster_size: int,
                               noise: torch.Tensor) -> torch.Tensor:
    """Cluster subsample given the (b, n) Gumbel draws: the ``num_out /
    cluster_size`` points of largest noise as seeds (a uniform draw of
    distinct points), each completed by its ``cluster_size`` nearest
    points, itself included."""
    b, n, _ = gt.shape
    n_seeds = num_out // cluster_size
    if n_seeds * cluster_size != num_out:
        raise ValueError(f"num_out={num_out} not divisible by "
                         f"cluster_size={cluster_size}")
    seed_pts = gather_point(gt, _top(noise, n_seeds, largest=True))
    d2 = torch.sum((seed_pts[:, :, None, :] - gt[:, None, :, :]) ** 2,
                   dim=-1)                                  # (b, s, n)
    nbr = _top(d2, cluster_size, largest=False)             # (b, s, cs)
    return gather_point(gt, nbr.reshape(b, -1))


def sample_cluster_inputs(gt: torch.Tensor, num_out: int,
                          generator: torch.Generator,
                          cluster_size: int = 4) -> torch.Tensor:
    """Cluster-structured subsample of each dense patch, the local
    structure of a pass-1 generator output (see
    :func:`sample_cluster_inputs_from`)."""
    b, n, _ = gt.shape
    return sample_cluster_inputs_from(gt, num_out, cluster_size,
                                      gumbel((b, n), generator, gt.device))


def sample_training_inputs(gt: torch.Tensor, num_out: int,
                           generator: torch.Generator,
                           cluster_prob: float = 0.0,
                           cluster_size: int = 4) -> torch.Tensor:
    """Random-mode input draw: the Gaussian-biased subsample, or with
    probability ``cluster_prob`` per example the cluster subsample."""
    if cluster_prob <= 0.0:
        return sample_nonuniform_inputs(gt, num_out, generator)
    nu = sample_nonuniform_inputs(gt, num_out, generator)
    cl = sample_cluster_inputs(gt, num_out, generator, cluster_size)
    use_cl = torch.rand((gt.shape[0], 1, 1), generator=generator,
                        device=gt.device) < cluster_prob
    return torch.where(use_cl, cl, nu)


def augment_batch_from(inputs: torch.Tensor, gt: torch.Tensor,
                       normal: torch.Tensor, angle: torch.Tensor,
                       scale: torch.Tensor, jitter_sigma: float = 0.01,
                       jitter_max: float = 0.03
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jitter (inputs only) → shared z rotation → shared scale, given the
    draws: ``normal`` standard normal of the inputs' shape, ``angle`` (b,)
    radians, ``scale`` (b, 1, 1).  The patch radius is not rescaled."""
    noise = torch.clamp(jitter_sigma * normal, -jitter_max, jitter_max)
    inputs = inputs + noise
    rot = rot_z(angle)
    inputs = torch.einsum("bnc,bcd->bnd", inputs, rot)
    gt = torch.einsum("bnc,bcd->bnd", gt, rot)
    return inputs * scale, gt * scale


def augment_batch(inputs: torch.Tensor, gt: torch.Tensor,
                  generator: torch.Generator, jitter_sigma: float = 0.01,
                  jitter_max: float = 0.03, scale_low: float = 0.8,
                  scale_high: float = 1.2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jitter, per-example z rotation and per-example scale in
    [scale_low, scale_high), drawn from ``generator``."""
    b, dev = inputs.shape[0], inputs.device
    normal = torch.randn(inputs.shape, generator=generator, device=dev)
    angle = torch.rand((b,), generator=generator, device=dev) * 2.0 * math.pi
    scale = (torch.rand((b, 1, 1), generator=generator, device=dev)
             * (scale_high - scale_low) + scale_low)
    return augment_batch_from(inputs, gt, normal, angle, scale,
                              jitter_sigma, jitter_max)
