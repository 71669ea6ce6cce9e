"""Inputs and weights made on the device from ``--seed``, in a few large
calls, by the parameters of a traffic mix and a configuration file.

Streams: the weights draw from ``seed``'s stream 0, the data from stream
1, a training step's draws from stream 2 (:func:`generator`), so that a
seed gives the same weights, clouds, patches and draws on every run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK63 = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one stream of ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + stream) & MASK63)


def host_rng(seed: int, stream: int) -> np.random.RandomState:
    return np.random.RandomState((int(seed) * 8 + stream) % (1 << 32))


def weights(shapes: dict, seed: int, device, stream: int = 0) -> dict:
    """{name: tensor} of the given shapes from one uniform draw: dense
    kernels (``*.dense.weight``, (out, in)) glorot-uniform, dense biases
    in ±0.05, batch-norm scale and variance in [0.8, 1.2), its bias and
    mean in ±0.1."""
    names = list(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    lo, hi = [], []
    for k in names:
        if k.endswith(".dense.weight"):
            out, inp = shapes[k]
            bound = math.sqrt(6.0 / (inp + out))
            lo.append(-bound), hi.append(bound)
        elif k.endswith((".bn.scale", ".bn.var")):
            lo.append(0.8), hi.append(1.2)
        elif k.endswith((".bn.bias", ".bn.mean")):
            lo.append(-0.1), hi.append(0.1)
        else:
            lo.append(-0.05), hi.append(0.05)
    counts = torch.tensor(sizes, device=device)
    lo = torch.repeat_interleave(torch.tensor(lo, device=device), counts)
    hi = torch.repeat_interleave(torch.tensor(hi, device=device), counts)
    u = torch.rand(sum(sizes), generator=generator(seed, stream, device),
                   device=device)
    flat = lo + (hi - lo) * u
    return {k: t.reshape(shapes[k]).clone()
            for k, t in zip(names, torch.split(flat, sizes))}


def make(kind: str, count: int, points: int, params: dict, seed: int,
         device) -> torch.Tensor:
    """(count, points, 3) inputs of the shape ``shapes/<kind>.py`` makes."""
    from port_bench.lib.cell import shape

    return shape(kind)(count, points, params, seed, device)
