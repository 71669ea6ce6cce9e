"""Height-field patches: the patch set of a training mix
(``"shape": "height_field"``), the program's ``synthetic_patches``
family made on the card in bulk."""

from __future__ import annotations

import math

import torch

from port_bench.lib.data import generator


def make(count: int, points: int, p: dict, seed: int, device,
         block: int = 4000) -> torch.Tensor:
    """(count, points, 3) patches of random height fields over [−1, 1]²
    (a quadric base, a crease at a random angle with slope in
    ``p['crease']``, a sine relief of amplitude in ``p['relief']``), each
    normalized to the unit sphere, as the PU-GAN patch set is."""
    g = generator(seed, 1, device)
    out = []
    for lo in range(0, count, block):
        n = min(block, count - lo)

        def rand(*shape):
            return torch.rand(shape, generator=g, device=device)

        uv = rand(n, points, 2) * 2.0 - 1.0
        u, v = uv[..., 0], uv[..., 1]
        a, b, c = (torch.randn((n, 3), generator=g, device=device) * 0.5
                   )[:, :, None].unbind(1)
        z = a * u ** 2 + b * v ** 2 + c * u * v
        theta = rand(n, 1) * math.pi
        c0, c1 = p["crease"]
        z = z + (c0 + (c1 - c0) * rand(n, 1)) * torch.abs(
            u * torch.cos(theta) + v * torch.sin(theta))
        fu, fv = (2.0 + 2.0 * rand(n, 2))[:, :, None].unbind(1)
        ph = rand(n, 2) * (2 * math.pi)
        r0, r1 = p["relief"]
        z = z + (r0 + (r1 - r0) * rand(n, 1)) * torch.sin(
            fu * math.pi * u + ph[:, :1]) * torch.sin(
            fv * math.pi * v + ph[:, 1:])
        x = torch.stack([u, v, z], dim=-1)
        x = x - torch.mean(x, dim=1, keepdim=True)
        x = x / torch.amax(torch.linalg.vector_norm(x, dim=-1), dim=1
                           )[:, None, None]
        out.append(x)
    return torch.cat(out).contiguous()
