"""Model FLOPs of one unit of a cell's work, counted over the reference
(``reference/flops.py``) on the CPU at one patch or one row of a batch:
every counted product is per patch (the generator, the critic and the
losses act on each patch alone), so a unit's FLOPs are that count times
its patches.  Selections are not counted; attention's products count at
the bf16 peak, as the card computes them."""

from __future__ import annotations

import math

import torch

from port_bench.reference.flops import FlopCount


def _cpu(weights):
    return {k: v.detach().cpu() for k, v in weights.items()}


def _sum(into, counts, times=1):
    for dt, f in counts.items():
        into[dt] = into.get(dt, 0) + f * times


@torch.no_grad()
def pass_flops(P, points):
    """{dtype: FLOPs} of one generator pass over one patch of ``points``."""
    from port_bench.reference.generator import generator

    x = torch.rand((1, points, 3), generator=torch.Generator().manual_seed(0))
    with FlopCount() as c:
        generator(P, x, attention_bf16=True)
    return dict(c.by_dtype)


def request_flops(weights, ratio, patches, patch_points):
    """A request of ``patches`` patches at ``ratio``: 4× a pass."""
    P = _cpu(weights)
    out, n = {}, patch_points
    for _ in range(max(1, round(math.log(ratio, 4)))):
        _sum(out, pass_flops(P, n), patches)
        n *= 4
    return out


def step_flops(weights, batch, gan, patch_points, input_points):
    """A training step of ``batch`` patches: the reference's step at one
    patch (forward and backward of the generator, the losses, with
    ``gan`` the critic's update and its pass for the generator), times the
    batch."""
    from port_bench.reference.training import Trainer

    W = {net: _cpu(w) for net, w in weights.items()}
    t = Trainer(W["G"], W.get("D"), attention_bf16=True)
    g = torch.Generator().manual_seed(0)
    gt = torch.rand((1, patch_points, 3), generator=g)
    with FlopCount() as c:
        t.step(gt, torch.ones(1), g, n_in=input_points)
    return {dt: f * batch for dt, f in c.by_dtype.items()}
