"""Whole-cloud upsampling in plain PyTorch, as Dis-PU's test protocol runs
it (``DisPU/model.py`` ``patch_prediction`` / ``pc_prediction``):
normalize the cloud, FPS seeds (n / patch · 3), the patch of each seed's
``patch`` nearest points, each patch normalized, the generator once per
pass (two chained 4× passes for 16×), the patches un-normalized, FPS
down to n · ratio points, the cloud un-normalized.

:func:`upsample` returns every stage, under the names that
``drivers/serve.py`` records from the benchmarked program, so that the
reference can stand in the program's place (the precision control).
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import ops
from port_bench.reference.generator import generator


def counts(n, ratio, patch=256, patch_ratio=3):
    return max(int(n / patch * patch_ratio), 1), n * ratio


def patch_cut(cloud_n, seeds, patch=256):
    """(1, n, 3) normalized cloud, (1, s) seed indices → (s, patch) int64
    indices of each seed's nearest points, nearest first."""
    return ops.knn(patch, cloud_n, ops.take(cloud_n, seeds))[0]


def passes(P, patches, num_passes, attention_bf16, block=8):
    """Each pass's (s, ·, 3) fine output, the generator run ``block``
    patches at a time."""
    out, x = [], patches
    for _ in range(num_passes):
        x = torch.cat([generator(P, x[i:i + block],
                                 attention_bf16=attention_bf16)[1]
                       for i in range(0, x.shape[0], block)])
        out.append(x)
    return out


@torch.no_grad()
def upsample(P, cloud, ratio, attention_bf16=False, patch=256):
    """(n, 3) cloud → the stages of one request: ``cloud_n`` (1, n, 3),
    ``seeds`` (1, s), ``patches`` (s, patch, 3) with ``p_centroid`` and
    ``p_furthest``, ``passes`` [(s, ·, 3)], ``candidates`` (1, N, 3),
    ``merged`` (1, n·ratio, 3), ``out`` (n·ratio, 3)."""
    cloud_n, centroid, furthest = ops.normalize(cloud[None])
    s, out_num = counts(cloud.shape[0], ratio, patch)
    seeds = ops.fps(s, cloud_n)
    idx = patch_cut(cloud_n, seeds, patch)
    patches, p_c, p_f = ops.normalize(cloud_n[0][idx])
    num_passes = max(1, round(math.log(ratio, 4)))
    outs = passes(P, patches, num_passes, attention_bf16)
    candidates = (outs[-1] * p_f + p_c).reshape(1, -1, 3)
    merged = ops.take(candidates, ops.fps(out_num, candidates))
    return dict(cloud_n=cloud_n, seeds=seeds, patches=patches,
                p_centroid=p_c, p_furthest=p_f, passes=outs,
                candidates=candidates, merged=merged,
                out=(merged * furthest + centroid)[0])
