"""Closed star-shaped surfaces: the clouds of a serving mix
(``"shape": "star"``)."""

from __future__ import annotations

import math

import torch

from port_bench.lib.data import generator


def make(count: int, points: int, p: dict, seed: int, device
         ) -> torch.Tensor:
    """(count, points, 3) closed star-shaped surfaces: directions uniform
    on the sphere, the radius ``1 + Σ a_j sin(f_j (d·u_j) + φ_j)`` over
    ``p['bumps']`` random waves (a_j in [0, p['amp']), f_j in
    ``p['freq']``), then a random axis scale in ``p['scale']``."""
    g = generator(seed, 1, device)
    j = p["bumps"]

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    d = torch.randn((count, points, 3), generator=g, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    axes = torch.randn((count, j, 3), generator=g, device=device)
    axes = axes / torch.linalg.vector_norm(axes, dim=-1, keepdim=True)
    amp = rand(count, j) * p["amp"]
    f0, f1 = p["freq"]
    freq = f0 + (f1 - f0) * rand(count, j)
    phase = rand(count, j) * (2 * math.pi)
    proj = torch.einsum("bnc,bjc->bnj", d, axes)
    r = 1.0 + torch.sum(amp[:, None] * torch.sin(freq[:, None] * proj
                                                 + phase[:, None]), -1)
    s0, s1 = p["scale"]
    scale = s0 + (s1 - s0) * rand(count, 1, 3)
    return (d * r[..., None] * scale).contiguous()
