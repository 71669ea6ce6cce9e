#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --profile  # and where a request's and a train
                                     # step's time goes

Phases, each of which fails the run (non-zero exit) when it fails:
  1. the card's name and power limit (nvidia-smi) and the CUDA version;
  2. build every kernel from ``dispu_tpu_torch/kernels/csrc`` with nvcc,
     all sources at once, into ``dispu_tpu_torch/_build/``;
  3. hold each kernel against its plain PyTorch version on the card, at
     the shapes the serving paths give it for 2048-point clouds (the 4×
     request, pass 2 of the 16× request, the 16× merge of one cloud and of
     two) and the train step gives it at batch 28 (backbone, refiner and
     chamfer kNN; the attention forward and its backward rule; the ball
     query in all three output modes, and at the critic's ball grouping),
     and time the kernel, the plain version and one PyTorch library call
     for the same function where there is one; the cluster FPS kernel also
     past its on-chip capacity and at a ragged n with ties across its
     blocks;
  4. drive each serving path at full GeneratorConfig() width from the
     port's own seeded init, on demo/gt/Icosahedron.xyz and
     demo/gt/fandisk.xyz, with the launch counts set to 0 just before each
     path and read just after: 6 whole-cloud 4× requests, 4 whole-cloud 16×
     requests, and ``upsample_many`` of both clouds at 4× and at 16× (twice
     each); compare each path's output with the same path run through the
     plain versions (impl='torch') on the card.  Then CD training at the
     same width with the training defaults (batch 28, random input,
     augmentation) on synthetic_patches: ``Trainer.train(epochs=2)`` of 3
     steps an epoch (logs, a checkpoint that restores bit-equal), 20 steps
     on one batch (the loss falls; ms per step), one step through the
     kernels against one through the plain versions (metrics, and a
     gradient at every parameter), and two 5-step runs that must agree
     bit for bit; each run with exact launch counts;
  5. print one JSON line listing every kernel with its numbers;
  6. print {"ok": true, "device": {...}} as the last line.

Exits non-zero without a result where no CUDA device is available, or
where the repository's package is missing beside this script.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # CUDA cores, float32
BF16_FLOPS = 989e12        # tensor cores, bf16

# contracts of the kernels against their plain versions on the card
KNN_DIST_RTOL = 1e-5       # kernel distances vs plain distances
KNN_SWAP_RTOL = 1e-6       # index differences only between such near-ties
ATTN_MAX_ABS = 1e-3        # kernel vs plain(bf16_operands=True), max
ATTN_MEAN_ABS = 1e-5       # ... and mean over all outputs
# kernel ms of each checked kNN shape, by label (the train step's shapes
# feed the training phase's per-step kernel time)
TRAIN_KNN_MS: dict = {}
# ball query vs plain: count, slot and selection differences only where a
# point's plain distance lies within this of r² (hit test) or of a
# competing slot's distance (ranking), relative to d + |q|² + |p|²; the
# slots' distances within QB_DIST_RTOL of the plain ones on that scale
QB_TIE_RTOL = 1e-6
QB_DIST_RTOL = 1e-5
# attention backward through the Function (kernel forward, f32 torch
# backward) vs autograd of the plain bf16 version (bf16-rounded operands
# and map): max |d| over max |grad| of each of dq, dk, dv
ATTN_BWD_REL = 2e-2
# one train step through the kernels vs through the plain versions on the
# card: each metric (relative) and each gradient (max |d| over the leaf's
# max |g|, floored at 1e-3 of the largest leaf's); the two differ by f32
# sum orders and the attention kernel's sums (kNN near-ties could move
# more).  Readings on an H100 at 700 W: 6.0e-8 and 1.3e-6; each limit
# leaves one to two orders of headroom.
TRAIN_METRIC_REL = 3e-6
TRAIN_GRAD_REL = 1e-4
# the whole path through the kernels vs through the plain versions
# generator 'fine' output per chunk, in patch units: rows agree to f32
# round-off except where a kNN near-tie (distances within ~1e-6) falls on
# the k-th place and the two paths keep different neighbours.  Readings on
# an H100 at 700 W: rows within 1e-4 0.99997, max |d| 5.4e-4; each limit
# leaves one to two orders of headroom.
GEN_ROW_ABS = 1e-4         # a row (point) within this counts as agreeing
GEN_ROW_FRAC = 0.99        # share of rows of each chunk that must agree
GEN_MAX_ABS = 1e-2         # no row beyond this
# symmetric Chamfer of the outputs (cloud units², from coordinate
# differences), by final ratio, for upsample and upsample_many alike.
# Readings on an H100 at 700 W: 4x 1.1e-11 and 1.6e-11 (upsample),
# 2.7e-16 and 4.7e-12 (upsample_many); 16x 4.7e-9 and 5.5e-10, 2.4e-9 and
# 5.1e-10.  At 16x pass 2 takes pass 1's output, so a near-tie swap there
# moves pass 2's candidates and the merge may pick other points.
CHAMFER_MAX = {4: 1e-9, 16: 1e-7}


def log(*args):
    print(*args, flush=True)


def require(ok, what) -> None:
    """Fail the run (exit 1) when a check does not hold; unlike
    ``assert``, it also holds under ``python -O``."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def timed_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, by CUDA
    events around the whole run, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, rate: float):
    """(least milliseconds, what bounds it) for ``nbytes`` moved and
    ``ops`` done at ``rate`` operations a second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timed_once(fn):
    """(result, device milliseconds) of one call of ``fn``, by CUDA events;
    for the plain FPS, whose one call is thousands of launches."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def load_cloud(name: str):
    import numpy as np

    path = os.path.join(REPO, "demo", "gt", name)
    return np.loadtxt(path, dtype=np.float32)[:, :3]


def chamfer(a, b, rows: int = 4096) -> float:
    """Symmetric Chamfer distance (mean squared nearest-neighbour distance
    each way) of two (n, 3) clouds on the card, in row blocks.  Distances
    from coordinate differences, not the |x|² − 2x·y + |y|² expansion,
    whose round-off (~1e-8 here) would hide equal clouds."""
    import torch

    def one_way(x, y):
        return sum(float((torch.cdist(
            x[i:i + rows], y, compute_mode="donot_use_mm_for_euclid_dist")
            ** 2).min(1).values.sum()) for i in range(0, len(x), rows)
        ) / len(x)

    a, b = torch.as_tensor(a).cuda(), torch.as_tensor(b).cuda()
    return one_way(a, b) + one_way(b, a)


# --------------------------------------------------------------- phase 3


def check_knn(dev):
    """Kernel vs plain at the serving path's kNN shapes.  Returns the
    per-request aggregate for the JSON line."""
    import numpy as np
    import torch

    from dispu_tpu_torch.kernels.knn import knn_cuda, knn_torch
    from dispu_tpu_torch.ops.geometry import (normalize_point_cloud,
                                              pairwise_sq_dist)
    from dispu_tpu_torch.ops.knn import mask_duplicate_rows

    gen = torch.Generator(device="cpu").manual_seed(1)
    cloud, _, _ = normalize_point_cloud(
        torch.from_numpy(load_cloud("Icosahedron.xyz")))

    def feats(b, n, c, n_dup):
        x = torch.randn(b, n, c, generator=gen)
        x[:, n - n_dup:] = x[:, :n_dup]  # duplicated rows, as in patches
        return x

    # (label, points, queries, k, duplicate bias, launches per 4x request);
    # the rest are the shapes of a 16x request's second pass and of a train
    # step at batch 28 (backbone, refiner, and the chamfer argmin at k = 1,
    # whose library call is cdist + argmin), checked and timed but not
    # counted in the 4x request's aggregate
    cases = [
        ("patch k256", cloud[None], cloud[None, ::85][:, :24], 256, False, 1),
        ("backbone c24", feats(32, 256, 24, 8), None, 17, True, 1),
        ("backbone c48", feats(32, 256, 48, 8), None, 17, True, 3),
        ("refiner", feats(32, 1024, 3, 0), None, 16, False, 1),
        ("p2 bbone c24", feats(32, 1024, 24, 8), None, 17, True, 0),
        ("p2 bbone c48", feats(32, 1024, 48, 8), None, 17, True, 0),
        ("p2 refiner", feats(32, 4096, 3, 0), None, 16, False, 0),
        ("train bb c24", feats(28, 256, 24, 8), None, 17, True, 0),
        ("train bb c48", feats(28, 256, 48, 8), None, 17, True, 0),
        ("train refiner", feats(28, 1024, 3, 0), None, 16, False, 0),
        ("chamfer k1", feats(28, 1024, 3, 0), feats(28, 1024, 3, 0), 1,
         False, 0),
    ]
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    for label, pts, qs, k, dup, per_req in cases:
        pts = pts.contiguous().to(dev)
        qs = pts if qs is None else qs.contiguous().to(dev)
        bias = (mask_duplicate_rows(pts).float() * 1e30) if dup else None
        dk, ik = knn_cuda(k, pts, qs, bias)
        dp, ip = knn_torch(k, pts, qs, bias)
        torch.cuda.synchronize()
        # the plain distance of each index the kernel chose must equal the
        # plain distance at that rank: index differences are then swaps
        # between near-ties.  Tolerances are relative, with the expansion's
        # cancellation scale |q|² + |p|² as the floor.
        full = pairwise_sq_dist(qs, pts)
        if bias is not None:
            full = full + bias[:, None, :]
        dk_plain = torch.gather(full, 2, ik.long())
        scale = 2.0 * float(torch.amax(torch.sum(pts * pts, -1)))
        swap_err = torch.abs(dk_plain - dp) / (torch.abs(dp) + scale)
        dist_err = torch.abs(dk - dp) / (torch.abs(dp) + scale)
        uniq = torch.sort(ik, dim=-1).values
        require(bool(torch.all(uniq[..., 1:] != uniq[..., :-1])),
                f"knn {label}: repeated index in a row")
        n_swaps = int((ik != ip).sum())
        require(float(swap_err.max()) <= KNN_SWAP_RTOL,
                f"knn {label}: index differs beyond a near-tie")
        require(float(dist_err.max()) <= KNN_DIST_RTOL,
                f"knn {label}: distance error {float(dist_err.max())}")
        max_abs = float(torch.abs(dk - dp).max())

        b, n, c = pts.shape
        m = qs.shape[1]
        ms = timed_ms(lambda: knn_cuda(k, pts, qs, bias), reps=20)
        plain_ms = timed_ms(lambda: knn_torch(k, pts, qs, bias), reps=5)

        def library():
            d = torch.cdist(qs, pts) ** 2
            if bias is not None:
                d = d + bias[:, None, :]
            if k == 1:
                return torch.argmin(d, dim=-1)
            return torch.topk(d, k, dim=-1, largest=False)

        library_ms = timed_ms(library, reps=5)
        nbytes = 4 * (b * n * c + b * m * c + (b * n if dup else 0)) \
            + 8 * b * m * k
        ops = b * m * n * (2 * c + 4)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        TRAIN_KNN_MS[label] = ms
        log(f"knn {label:13s} (b={b} n={n} m={m} c={c} k={k}): "
            f"max|d|err {max_abs:.3e} rel {float(dist_err.max()):.2e}, "
            f"swaps {n_swaps}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cdist+{'argmin' if k == 1 else 'topk'} {library_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by})")
        agg["ms"] += per_req * ms
        agg["plain_ms"] += per_req * plain_ms
        agg["library_ms"] += per_req * library_ms
        agg["bound_ms"] += per_req * bms
        agg["t_bytes"] += per_req * nbytes / HBM_BYTES_PER_S
        agg["t_ops"] += per_req * ops / F32_FLOPS
        agg["max_abs_err"] = max(agg["max_abs_err"], max_abs)
    return agg


def check_fps(dev):
    import torch

    from dispu_tpu_torch.kernels.fps import fps_cuda, fps_torch
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    gen = torch.Generator(device="cpu").manual_seed(2)
    cloud, _, _ = normalize_point_cloud(
        torch.from_numpy(load_cloud("fandisk.xyz")))
    merged = torch.randn(1, 24576, 3, generator=gen)
    merged[:, 20000:20100] = merged[:, :100]  # duplicated points
    # (label, xyz, npoint, launches per 4x request)
    cases = [("seeds", cloud[None], 24, 1), ("merge", merged, 8192, 1)]
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    for label, xyz, npoint, per_req in cases:
        xyz = xyz.contiguous().to(dev)
        got = fps_cuda(npoint, xyz)
        want = fps_torch(npoint, xyz)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        require(n_diff == 0, f"fps {label}: {n_diff} indices differ")
        b, n, _ = xyz.shape
        ms = timed_ms(lambda: fps_cuda(npoint, xyz), reps=10)
        plain_ms = timed_ms(lambda: fps_torch(npoint, xyz), reps=1,
                            warmup=1)
        nbytes = 12 * b * n + 4 * b * npoint
        ops = 9 * b * n * (npoint - 1)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"fps {label:6s} (b={b} n={n} -> {npoint}): bit-equal; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
        agg["ms"] += per_req * ms
        agg["plain_ms"] += per_req * plain_ms
        agg["bound_ms"] += per_req * bms
        agg["t_bytes"] += per_req * nbytes / HBM_BYTES_PER_S
        agg["t_ops"] += per_req * ops / F32_FLOPS
    return agg


def check_fps_chunked(dev):
    """The cluster FPS kernel bit-equal to the plain FPS at (a) the 16×
    merge of a 2048-point cloud, (b) the same for two clouds (the
    streaming merge), (c) one cloud past the cluster's on-chip capacity
    (the 16× merge of a 10k-point cloud, cut to 512 samples) and (d) a
    ragged n with tied distances across the blocks' index ranges and more
    samples than distinct points.  Times (a) and (b); the aggregate is (a),
    the kernel's one launch in a 16× request."""
    import torch

    from dispu_tpu_torch.kernels import fps_chunked
    from dispu_tpu_torch.kernels.fps import fps_torch
    from dispu_tpu_torch.kernels.fps_chunked import fps_chunked_cuda

    gen = torch.Generator(device="cpu").manual_seed(4)

    def merged(b, n):
        x = torch.randn(b, n, 3, generator=gen)
        x[:, n - 1000:] = x[:, :1000]  # duplicated points
        return x

    n_d = 40003  # 8 blocks of 5001 points, the last one of 4996
    ragged = torch.randn(2, n_d, 3, generator=gen)
    ragged[0] = torch.randn(37, 3, generator=gen).repeat(n_d // 37 + 1, 1)[
        :n_d]  # 37 distinct points, ties in every block
    ragged[1, 5001:5101] = ragged[1, 4901:5001]  # ties across blocks 0 and 1
    # (label, xyz, npoint, timed)
    cases = [("16x merge", merged(1, 98304), 32768, True),
             ("16x stream", merged(2, 98304), 32768, True),
             ("past capacity", merged(1, 479232), 512, False),
             ("n=120000", torch.randn(2, 120000, 3, generator=gen), 256,
              False),
             ("ragged ties", ragged, 64, False)]
    agg = None
    for label, xyz, npoint, timed in cases:
        xyz = xyz.contiguous().to(dev)
        got = fps_chunked_cuda(npoint, xyz)
        want, plain_ms = timed_once(lambda: fps_torch(npoint, xyz))
        n_diff = int((got != want).sum())
        require(n_diff == 0, f"fps_chunked {label}: {n_diff} indices differ")
        b, n, _ = xyz.shape
        if not timed:
            log(f"fps_chunked {label} (b={b} n={n} -> {npoint}): bit-equal")
            continue
        ms = timed_ms(lambda: fps_chunked_cuda(npoint, xyz), reps=3,
                      warmup=1)
        nbytes = 12 * b * n + 4 * b * npoint
        ops = 9 * b * n * (npoint - 1)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"fps_chunked {label} (b={b} n={n} -> {npoint}): bit-equal; "
            f"kernel {ms:.4f} ms ({ms / (npoint - 1) * 1e3:.3f} us a round), "
            f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
        if agg is None:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / F32_FLOPS, max_abs_err=0.0)
    log("fps_chunked clusters the card holds at once, by (device, form): "
        f"{fps_chunked.MAX_CLUSTERS}")
    return agg


def check_attention(dev):
    """Kernel vs plain at the NL cell's shapes: the 4× request's map
    (1024 × 1024, counted in the aggregate) and pass 2 of a 16× request
    (4096 × 4096, checked and timed only); and the widest instantiation."""
    import torch
    import torch.nn.functional as F

    from dispu_tpu_torch.kernels.attention import (attention_cuda,
                                                   attention_torch)

    gen = torch.Generator(device="cpu").manual_seed(3)
    b, c = 32, 64
    scale = 1.0 / math.sqrt(c)
    agg = None
    for n in (1024, 4096):
        q, k, v = (torch.randn(b, n, c, generator=gen).to(dev)
                   for _ in range(3))
        got = attention_cuda(q, k, v, scale)
        want = attention_torch(q, k, v, scale, bf16_operands=True)
        f32 = attention_torch(q, k, v, scale)
        torch.cuda.synchronize()
        err = torch.abs(got - want)
        max_abs, mean_abs = float(err.max()), float(err.mean())
        dev_f32 = float(torch.abs(got - f32).max())
        require(max_abs <= ATTN_MAX_ABS and mean_abs <= ATTN_MEAN_ABS,
                f"attention n={n}: max|d| {max_abs}, mean {mean_abs}")
        ms = timed_ms(lambda: attention_cuda(q, k, v, scale), reps=10)
        plain_ms = timed_ms(
            lambda: attention_torch(q, k, v, scale, bf16_operands=True),
            reps=5)
        library_ms = timed_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            reps=5)
        nbytes = 4 * (3 * b * n * c + b * n * c)
        ops = 2 * b * n * n * (c + c)
        bms, by = bound(nbytes, ops, BF16_FLOPS)
        log(f"attention (b={b} nq=nk={n} c=cv={c}): max|d| {max_abs:.3e} "
            f"(bound {ATTN_MAX_ABS}), mean {mean_abs:.3e}, vs f32 plain "
            f"{dev_f32:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if agg is None:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / BF16_FLOPS, max_abs_err=max_abs)
    # the backward at the train step's shape: the Function (kernel forward,
    # the JAX package's rule in f32 torch ops) against autograd of the
    # plain bf16 version
    from dispu_tpu_torch.kernels.attention import AttentionFunction

    bt = 28
    q, k, v, do = (torch.randn(bt, 1024, c, generator=gen).to(dev)
                   for _ in range(4))
    grads = []
    for fn in (lambda a, b_, v_: AttentionFunction.apply(a, b_, v_, scale,
                                                         True),
               lambda a, b_, v_: attention_torch(a, b_, v_, scale,
                                                 bf16_operands=True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves).backward(do)
        grads.append([t.grad for t in leaves])
    rels = [float(torch.abs(a - b_).max() / torch.abs(b_).max())
            for a, b_ in zip(*grads)]
    require(max(rels) <= ATTN_BWD_REL,
            f"attention backward rel deviation {rels}")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = AttentionFunction.apply(*leaves, scale, True)
    bwd_ms = timed_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                  retain_graph=True), reps=5)
    fwd_ms = timed_ms(lambda: attention_cuda(q, k, v, scale), reps=10)
    agg["train_fwd_ms"], agg["train_bwd_ms"] = fwd_ms, bwd_ms
    log(f"attention train shape (b={bt} nq=nk=1024 c=cv={c}): kernel "
        f"forward {fwd_ms:.4f} ms; backward (f32 torch ops, map "
        f"recomputed) {bwd_ms:.4f} ms; dq, dk, dv vs autograd of the bf16 "
        f"plain version: max|d|/max|g| {['%.2e' % r for r in rels]} (bound "
        f"{ATTN_BWD_REL})")
    # the widest instantiation (cv > 128), which fine_extractor=True reaches
    # at c = cv = 184; checked here, timed nowhere
    n = 1024
    qw, kw, vw = (torch.randn(4, n, 184, generator=gen).to(dev)
                  for _ in range(3))
    wide = float(torch.abs(
        attention_cuda(qw, kw, vw, 184 ** -0.5)
        - attention_torch(qw, kw, vw, 184 ** -0.5, bf16_operands=True)).max())
    require(wide <= ATTN_MAX_ABS, f"attention c=cv=184: max|d| {wide}")
    log(f"attention (b=4 nq=nk={n} c=cv=184): max|d| {wide:.3e} "
        f"(bound {ATTN_MAX_ABS})")
    return agg


def check_query_ball(dev):
    """Kernel vs plain in all three output modes at the repulsion loss's
    shape (28 clouds of 1024 points, every point a query, r = 0.07,
    nsample 20, select 5) and at the critic's ``knn=False`` grouping
    (28 × 1024 points, 128 queries, r = 0.2, nsample 64), under the
    near-tie contract.  Times the select mode (what the repulsion loss
    runs); the aggregate is the repulsion shape, one launch a train
    step."""
    import torch

    from dispu_tpu_torch.data.dataset import synthetic_patches
    from dispu_tpu_torch.kernels.query_ball import (query_ball_cuda,
                                                    query_ball_torch)
    from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

    pts = torch.from_numpy(synthetic_patches(28, 1024, seed=7)[1]).to(dev)
    pts[:, 900:950] = pts[:, 100:150]  # duplicates: tied distances
    cases = [("repulsion", pts, pts, 0.07, 20, 5),
             ("critic ball", pts, pts[:, ::8].contiguous(), 0.2, 64, 5)]
    agg = None
    for label, xyz, qs, r, ns, s in cases:
        b, n, c = xyz.shape
        m = qs.shape[1]
        d = pairwise_sq_dist(qs, xyz)                       # (b, m, n)
        scale = (torch.sum(qs * qs, -1)[..., None]
                 + torch.sum(xyz * xyz, -1)[:, None, :])
        r2 = torch.tensor(r, dtype=torch.float32) ** 2
        boundary = torch.any(torch.abs(d - float(r2))
                             <= QB_TIE_RTOL * (float(r2) + scale), dim=-1)
        got = query_ball_cuda(r, ns, xyz, qs, True, s)
        want = query_ball_torch(r, ns, xyz, qs, True, s)
        torch.cuda.synchronize()
        slots_ok = (torch.all(got[0] == want[0], dim=-1)
                    & (got[1] == want[1]))
        n_boundary = int((~slots_ok).sum())
        require(bool(torch.all(slots_ok | boundary)),
                f"ball {label}: slots differ away from the hit boundary")
        same = slots_ok[..., None]
        dscale = torch.gather(scale, -1, want[0].long())
        derr = torch.abs(got[2] - want[2]) / (torch.abs(want[2]) + dscale)
        max_derr = float(torch.where(same, derr, 0.0).max())
        require(max_derr <= QB_DIST_RTOL,
                f"ball {label}: distance error {max_derr}")
        # a selection may differ only between slots whose plain distances
        # tie to QB_TIE_RTOL: rank by rank, the plain distance of the
        # kernel's choice equals that of the plain version's choice
        dk = torch.gather(d, -1, got[3].long())
        dp = torch.gather(d, -1, want[3].long())
        sel_scale = torch.gather(scale, -1, want[3].long())
        tie = torch.abs(dk - dp) <= QB_TIE_RTOL * (dp + sel_scale)
        sel_diff = (got[3] != want[3]) & same
        n_sel = int(sel_diff.sum())
        require(bool(torch.all(tie | ~sel_diff)),
                f"ball {label}: selection differs beyond a near-tie")
        # the two narrower modes return the same slots as the widest
        plain_only = query_ball_cuda(r, ns, xyz, qs)
        dists_only = query_ball_cuda(r, ns, xyz, qs, True)
        require(all(torch.equal(a, b_) for a, b_ in
                    zip(plain_only + dists_only, got[:2] + got[:3])),
                f"ball {label}: modes disagree")
        ms = timed_ms(lambda: query_ball_cuda(r, ns, xyz, qs, False, s),
                      reps=20)
        plain_ms = timed_ms(lambda: query_ball_torch(r, ns, xyz, qs, False,
                                                     s), reps=5)
        # the points each query must scan: up to its nsample-th hit
        full = want[1] == ns
        scanned = torch.where(full, want[0][..., -1].long() + 1, n)
        ops = float(scanned.sum()) * (3 * c + 3)
        nbytes = 4 * (b * n * c + b * m * c + b * m * ns + b * m + b * m * s)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"query_ball {label} (b={b} n={n} m={m} c={c} r={r} ns={ns} "
            f"s={s}): hit-boundary rows {n_boundary}, selection near-tie "
            f"swaps {n_sel}, dists rel err {max_derr:.2e} (bound "
            f"{QB_DIST_RTOL}), mean hits {float(want[1].float().mean()):.2f};"
            f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bms:.5f} ms ({by})")
        if agg is None:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / F32_FLOPS,
                       max_abs_err=float(torch.where(
                           same, torch.abs(got[2] - want[2]), 0.0).max()))
    return agg


# --------------------------------------------------------------- phase 4


def expected_counts(up, n: int, b: int = 1) -> dict:
    """Kernel launches of one call of ``up``'s path on b clouds of n points,
    from ``plan_counts``: one seed FPS and one patch kNN for all b clouds;
    per chunk of patches and pass, 5 kNN (4 backbone, 1 refiner) and one
    attention; one merge FPS, in the kernel that takes its candidates."""
    from dispu_tpu_torch.inference import plan_counts
    from dispu_tpu_torch.ops.sampling import fps_kernel_for

    seed_num, _ = plan_counts(n, up.inf_cfg)
    chunks = -(-b * seed_num // up.inf_cfg.patch_batch)
    candidates = (seed_num * up.inf_cfg.patch_num_point
                  * up.gen_cfg.up_ratio ** up.num_passes)
    counts = dict(knn=1 + 5 * chunks * up.num_passes, fps=1, fps_chunked=0,
                  attention=chunks * up.num_passes, query_ball=0)
    counts[fps_kernel_for(candidates)] += 1
    return counts


def add_counts(total: dict, counts: dict, times: int = 1) -> dict:
    return {k: total.get(k, 0) + times * counts[k] for k in counts}


def serve(card: str):
    import numpy as np
    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.inference import PatchUpsampler, plan_counts
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    up = PatchUpsampler(device="cuda", seed=0)
    clouds = {name: load_cloud(name)
              for name in ("Icosahedron.xyz", "fandisk.xyz")}
    expected = {}
    for pc in clouds.values():
        expected = add_counts(expected, expected_counts(up, pc.shape[0]), 3)

    outs, times = {}, {}
    kernels.reset_launch_counts()
    for name, pc in clouds.items():
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = up.upsample(pc)  # returns on the host: synchronized
            times.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            require(out.shape == (pc.shape[0] * 4, 3), out.shape)
            require(np.isfinite(out).all(), f"{name}: non-finite output")
            if rep:
                require(np.array_equal(out, outs[name]),
                        f"{name}: repeated request differs")
            outs[name] = out
    counts = kernels.launch_counts()
    log(f"launches over 6 4x requests: {counts} (expected {expected})")
    require(counts == expected, f"launch counts {counts} != {expected}")

    ref = PatchUpsampler(device="cuda", seed=0, impl="torch")
    max_gen, max_cd = 0.0, 0.0
    with torch.inference_mode():
        for name, pc in clouds.items():
            cd = chamfer(outs[name], ref.upsample(pc))
            pc_n, _, _ = normalize_point_cloud(torch.from_numpy(pc).cuda())
            seed_num, _ = plan_counts(pc.shape[0], up.inf_cfg)
            patches, _, _, seeds = up.prepare(pc_n[None], seed_num)
            _, _, _, seeds_ref = ref.prepare(pc_n[None], seed_num)
            require(torch.equal(seeds, seeds_ref), f"{name}: seeds differ")
            gen_err, agree = [], []
            for chunk in up.chunks(patches):
                row = torch.abs(up.model(chunk)[1]
                                - ref.model(chunk)[1]).amax(dim=-1)
                gen_err.append(float(row.max()))
                agree.append(float((row <= GEN_ROW_ABS).float().mean()))
            log(f"{name}: kernels vs plain path on the card: Chamfer "
                f"{cd:.3e} (bound {CHAMFER_MAX[4]}); generator per chunk: "
                f"max|d| {['%.3e' % e for e in gen_err]} (bound "
                f"{GEN_MAX_ABS}), rows within {GEN_ROW_ABS} "
                f"{['%.5f' % a for a in agree]} (bound {GEN_ROW_FRAC})")
            require(min(agree) >= GEN_ROW_FRAC, f"{name}: rows agree {agree}")
            max_gen, max_cd = max(max_gen, *gen_err), max(max_cd, cd)
    require(max_gen <= GEN_MAX_ABS, f"generator deviation {max_gen}")
    require(max_cd <= CHAMFER_MAX[4], f"Chamfer {max_cd}")

    warm = [t for ts in times.values() for t in ts[1:]]
    log(f"ms per 2048-point 4x request after warm-up: mean "
        f"{sum(warm) / len(warm):.2f} ({', '.join('%.2f' % t for t in warm)};"
        f" first requests {[round(ts[0], 2) for ts in times.values()]}) "
        f"on {card}")
    return counts


def serve_16x(card: str):
    """Two 16× requests on each demo cloud; the same requests through the
    plain versions on the card."""
    import numpy as np
    import torch

    from dispu_tpu_torch import InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler, plan_counts
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    inf = InferenceConfig(final_ratio=16)
    up = PatchUpsampler(device="cuda", seed=0, inf_cfg=inf)
    clouds = {name: load_cloud(name)
              for name in ("Icosahedron.xyz", "fandisk.xyz")}
    expected = {}
    for pc in clouds.values():
        expected = add_counts(expected, expected_counts(up, pc.shape[0]), 2)

    outs, times = {}, []
    kernels.reset_launch_counts()
    for name, pc in clouds.items():
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = up.upsample(pc)
            times.append((time.perf_counter() - t0) * 1e3)
            require(out.shape == (pc.shape[0] * 16, 3), out.shape)
            require(np.isfinite(out).all(), f"16x {name}: non-finite output")
            if rep:
                require(np.array_equal(out, outs[name]),
                        f"16x {name}: repeated request differs")
            outs[name] = out
    counts = kernels.launch_counts()
    log(f"launches over 4 16x requests: {counts} (expected {expected})")
    require(counts == expected, f"16x launch counts {counts} != {expected}")

    ref = PatchUpsampler(device="cuda", seed=0, inf_cfg=inf, impl="torch")
    with torch.inference_mode():
        for name, pc in clouds.items():
            out_ref, plain_ms = timed_once(lambda: ref.upsample(pc))
            cd = chamfer(outs[name], out_ref)
            pc_n, _, _ = normalize_point_cloud(torch.from_numpy(pc).cuda())
            seed_num, _ = plan_counts(pc.shape[0], inf)
            seeds = up.prepare(pc_n[None], seed_num)[3]
            require(torch.equal(seeds, ref.prepare(pc_n[None], seed_num)[3]),
                    f"16x {name}: seeds differ")
            log(f"16x {name}: kernels vs plain path on the card: seeds "
                f"equal, Chamfer {cd:.3e} (bound {CHAMFER_MAX[16]}); plain "
                f"request {plain_ms:.1f} ms")
            require(cd <= CHAMFER_MAX[16], f"16x {name}: Chamfer {cd}")
    warm = times[1::2]
    log(f"ms per 2048-point 16x request after warm-up: mean "
        f"{sum(warm) / len(warm):.2f} ({', '.join('%.2f' % t for t in warm)};"
        f" first requests {[round(t, 2) for t in times[0::2]]}) on {card}")
    return counts


def serve_stream(card: str):
    """upsample_many of both demo clouds at 4× and at 16×, twice each; the
    same calls through the plain versions on the card."""
    import numpy as np
    import torch

    from dispu_tpu_torch import InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler, plan_counts
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    pcs = np.stack([load_cloud("Icosahedron.xyz"), load_cloud("fandisk.xyz")])
    b, n, _ = pcs.shape
    total = {}
    for ratio in (4, 16):
        inf = InferenceConfig(final_ratio=ratio)
        up = PatchUpsampler(device="cuda", seed=0, inf_cfg=inf)
        expected = add_counts({}, expected_counts(up, n, b), 2)
        outs, times = [], []
        kernels.reset_launch_counts()
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(up.upsample_many(pcs))
            times.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        log(f"launches over 2 {ratio}x upsample_many calls (B={b}): "
            f"{counts} (expected {expected})")
        require(counts == expected,
                f"{ratio}x stream launch counts {counts} != {expected}")
        require(outs[0].shape == (b, n * ratio, 3), outs[0].shape)
        require(np.isfinite(outs[0]).all(), f"{ratio}x stream: non-finite")
        require(np.array_equal(outs[0], outs[1]),
                f"{ratio}x stream: repeated call differs")

        ref = PatchUpsampler(device="cuda", seed=0, inf_cfg=inf,
                             impl="torch")
        with torch.inference_mode():
            out_ref, plain_ms = timed_once(lambda: ref.upsample_many(pcs))
            pcs_n, _, _ = normalize_point_cloud(torch.from_numpy(pcs).cuda())
            seed_num, _ = plan_counts(n, inf)
            require(torch.equal(up.prepare(pcs_n, seed_num)[3],
                                ref.prepare(pcs_n, seed_num)[3]),
                    f"{ratio}x stream: seeds differ")
        cds = [chamfer(outs[0][v], out_ref[v]) for v in range(b)]
        log(f"{ratio}x upsample_many: kernels vs plain path on the card: "
            f"seeds equal, Chamfer {['%.3e' % c for c in cds]} (bound "
            f"{CHAMFER_MAX[ratio]}); plain call {plain_ms:.1f} ms")
        require(max(cds) <= CHAMFER_MAX[ratio],
                f"{ratio}x stream: Chamfer {cds}")
        log(f"ms per {ratio}x upsample_many call (B={b}, {n} points each): "
            f"{', '.join('%.2f' % t for t in times)} (the first warms up) "
            f"on {card}")
        total = add_counts(total, counts)
    return total


# ------------------------------------------------------ phase 4: training


def expected_train_counts(cfg) -> dict:
    """Kernel launches of one train step, from the configuration: a
    feature-space kNN in each dense block and the refiner's xyz kNN; the
    chamfer argmin of both directions of the four Chamfer/Hausdorff terms
    (kNN at k = 1: 64 ≤ points ≤ 4096); the NL cell's attention (maps of
    at least 512²); one ball query for the repulsion loss."""
    g, n_out = cfg.generator, cfg.generator.num_out_points
    argmin = 8 if 64 <= n_out <= 4096 else 0
    nl = g.refine and g.use_nonlocal and n_out * n_out >= 512 * 512
    return dict(knn=g.dense_block + int(g.refine) + argmin, fps=0,
                fps_chunked=0, attention=int(nl),
                query_ball=int(cfg.loss.use_repulsion))


def _grads(model) -> dict:
    import torch

    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                ).detach().clone() for n, p in model.named_parameters()}


def train_phase(card: str, profile: bool):
    """CD training at full GeneratorConfig() width with the TrainConfig,
    LossConfig and DataConfig defaults (batch 28, random input, augment
    on) on synthetic_patches, from the port's seeded init."""
    import dataclasses
    import shutil
    import statistics

    import numpy as np
    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.config import ExperimentConfig, TrainConfig
    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step
    from dispu_tpu_torch.train.trainer import Trainer
    from dispu_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                  restore_checkpoint)

    t_phase = time.perf_counter()
    log_dir = os.path.join(REPO, "chiprun_out", "train_smoke")
    shutil.rmtree(log_dir, ignore_errors=True)
    cfg = ExperimentConfig(
        train=dataclasses.replace(TrainConfig(), epoch_per_save=1,
                                  steps_per_print=2),
        log_dir=log_dir)
    bs = cfg.train.batch_size
    per_step = expected_train_counts(cfg)
    dataset = PatchDataset(h5_path=os.path.join(log_dir, "absent.h5"),
                           synthetic_patches_count=3 * bs, seed=0)

    # (a) Trainer: 2 epochs of 3 steps, logs and checkpoints
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state = Trainer(cfg, dataset=dataset).train(epochs=2)
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expected = add_counts({}, per_step, 6)
    log(f"training: Trainer.train(epochs=2), 6 steps of batch {bs}, "
        f"{trainer_s:.2f} s with set-up; launches {counts} (expected "
        f"{expected})")
    require(counts == expected, f"train launch counts {counts}")
    total_counts = counts
    names = set(os.listdir(log_dir))
    require({"args.txt", "scalars.jsonl", "log_train.txt"} <= names,
            f"training logs missing: {sorted(names)}")
    epoch, path = latest_checkpoint(log_dir)
    require(epoch == 2, f"no checkpoint of epoch 2 in {sorted(names)}")
    back = restore_checkpoint(path, create_generator_state(
        cfg.generator, seed=11, device="cuda"))
    mine, theirs = state.model.state_dict(), back.model.state_dict()
    require(all(torch.equal(mine[k], theirs[k]) for k in mine)
            and all(torch.equal(state.mu[k], back.mu[k])
                    and torch.equal(state.nu[k], back.nu[k])
                    for k in state.mu)
            and (back.count, back.step) == (state.count, state.step),
            "restored checkpoint differs")
    for line in open(os.path.join(log_dir, "log_train.txt")):
        log("  " + line.rstrip())

    # (b) ~20 steps on one fixed batch: the loss falls; ms per warm step
    gt = torch.from_numpy(dataset.gt[:bs]).cuda()
    radius = torch.from_numpy(dataset.radius[:bs]).cuda()

    def run(impl, steps, seed=0, times=None):
        st = create_generator_state(cfg.generator, seed=0, impl=impl,
                                    device="cuda")
        step = make_train_step(cfg, impl=impl)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        totals = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, m = step(st, gt, radius, gen)
            totals.append(float(m["total"]))  # a host fetch: synchronized
            if times is not None:
                times.append((time.perf_counter() - t) * 1e3)
        return st, totals, m

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    _, totals, _ = run("auto", 20, times=times)
    counts = kernels.launch_counts()
    require(counts == add_counts({}, per_step, 20),
            f"launch counts over 20 steps {counts}")
    total_counts = add_counts(total_counts, counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    warm = times[1:]
    log(f"training: 20 steps on one batch: total {totals[0]:.4f} -> "
        f"{totals[-1]:.4f}; launches {counts}; ms per warm step: median "
        f"{statistics.median(warm):.3f} (min {min(warm):.3f}, max "
        f"{max(warm):.3f}, first step {times[0]:.1f}); peak memory "
        f"{peak_gb:.2f} GB; on {card}")
    require(np.isfinite(totals).all() and totals[-1] < totals[0],
            f"loss did not fall: {totals}")

    # (c) one step through the kernels and through the plain versions
    st_k, _, m_k = run("cuda", 1)
    g_k = _grads(st_k.model)
    st_p, _, m_p = run("torch", 1)
    g_p = _grads(st_p.model)
    metric_rel = max(abs(float(m_k[k]) - float(m_p[k]))
                     / max(abs(float(m_p[k])), 1e-12) for k in m_p)
    top = max(float(g.abs().max()) for g in g_p.values())
    grad_rel = max(float((g_k[n] - g_p[n]).abs().max())
                   / max(float(g_p[n].abs().max()), 1e-3 * top)
                   for n in g_p)
    dead = sorted(n for n in g_p if bool(g_p[n].abs().max() > 0)
                  and not bool(g_k[n].abs().max() > 0))
    log(f"training: one step, kernels vs plain versions on the card: "
        f"metrics max rel {metric_rel:.3e} (bound {TRAIN_METRIC_REL}), "
        f"gradients max |d| / leaf max {grad_rel:.3e} (bound "
        f"{TRAIN_GRAD_REL}); {len(g_p)} parameters, gradient zero through "
        f"the kernels only at {dead}; NL cell conv_kv / conv_query max|g| "
        + ", ".join("%.3e" % float(g_k[n].abs().max()) for n in g_k
                    if "nonlocal.conv_kv.dense.weight" in n
                    or "nonlocal.conv_query.dense.weight" in n))
    require(not dead, f"no gradient through the kernels at {dead}")
    require(metric_rel <= TRAIN_METRIC_REL, f"metrics differ {metric_rel}")
    require(grad_rel <= TRAIN_GRAD_REL, f"gradients differ {grad_rel}")

    # (d) two runs of 5 steps from the same state and seed: bit-equal
    runs = [run("auto", 5, seed=3)[0] for _ in range(2)]
    sd = [r.model.state_dict() for r in runs]
    n_diff = sum(not torch.equal(sd[0][k], sd[1][k]) for k in sd[0])
    log(f"training: two runs of 5 steps, tensors that differ: {n_diff} of "
        f"{len(sd[0])}")
    require(n_diff == 0, f"repeated training differs in {n_diff} tensors")

    log(f"training phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    if profile:
        profile_train_step(cfg, gt, radius)
    return total_counts


def profile_train_step(cfg, gt, radius):
    """One warm train step split into forward, losses, backward and Adam
    (synchronized stages), then device time by kernel and the idle share
    of one unsplit step under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dispu_tpu_torch import losses as L
    from dispu_tpu_torch.data.augment import (augment_batch,
                                              sample_training_inputs)
    from dispu_tpu_torch.train.state import (adam_update,
                                             create_generator_state)
    from dispu_tpu_torch.train.steps import deterministic, make_train_step

    st = create_generator_state(cfg.generator, device="cuda")
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        step(st, gt, radius, gen)
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    dev = torch.device("cuda")
    with deterministic(dev):
        inputs = stage("draw + augment", lambda: augment_batch(
            sample_training_inputs(gt, cfg.generator.num_points, gen), gt,
            gen))
        model = st.model.train()
        model.zero_grad(set_to_none=True)
        coarse, fine = stage("forward", lambda: model(inputs[0]))
        total, _ = stage("losses", lambda: L.pu_losses(
            coarse, fine, inputs[1], radius, 0.01, cfg.loss))
        stage("backward", lambda: total.backward())
        stage("adam", lambda: adam_update(st, 1e-3, cfg.train))
    log("train step stage ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(st, gt, radius, gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(st, gt, radius, gen)
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3,
                                 n + 1)
    if not by_name:
        log("profiler: no device time traced")
        return
    busy = sum(ms for ms, _ in by_name.values())
    log(f"profiled train step: device busy {busy:.3f} ms of {wall_ms:.3f} "
        f"ms wall (unprofiled), idle share {1 - busy / wall_ms:.3f}; "
        f"{sum(n for _, n in by_name.values())} device kernels")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:20]:
        log(f"  {ms:9.3f} ms  x{n:4d}  {name[:110]}")


def profile_request(up, pc):
    """Where one warm request's time goes: host-clock stage times around
    synchronized stages (each generator pass on its own), then a
    torch.profiler trace of one request with device time summed by kernel
    name and the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dispu_tpu_torch.inference import plan_counts
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    seed_num, out_num = plan_counts(pc.shape[0], up.inf_cfg)
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    log(f"profile of one {up.inf_cfg.final_ratio}x request:")
    with torch.inference_mode():
        up.upsample(pc)  # warm
        pc_n, _, _ = stage("normalize", lambda: normalize_point_cloud(
            torch.from_numpy(pc).cuda()))
        patches, cen, fur, _ = stage(
            "prepare: seed FPS, patch kNN",
            lambda: up.prepare(pc_n[None], seed_num))
        preds = up.chunks(patches)
        for i in range(up.num_passes):
            preds = stage(
                f"generate: pass {i + 1}, {len(preds)} chunk(s) of "
                f"{tuple(preds[0].shape)}",
                lambda: [up.model(chunk)[1] for chunk in preds])
        pred = torch.cat(preds)[: patches.shape[0]] * fur + cen
        stage(f"merge FPS ({pred.shape[0] * pred.shape[1]} -> {out_num})",
              lambda: up.merge(pred.reshape(1, -1, 3), out_num))
    log("stage ms: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    up.upsample(pc)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        up.upsample(pc)
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3,
                                 n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    if not by_name:
        log("profiler: no device time traced")
        return
    log(f"profiled request: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"wall (unprofiled), idle share {1 - busy / wall_ms:.3f}; "
        f"{sum(n for _, n in by_name.values())} device kernels")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        log(f"  {ms:9.3f} ms  x{n:4d}  {name[:110]}")


# ------------------------------------------------------------------ main


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="in phase 4, break one request and one train "
                             "step down by stage and by device kernel")
    args = parser.parse_args()

    # cuBLAS is deterministic only with a fixed workspace, which it reads
    # when it starts; the train step runs under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dispu_tpu_torch.inference import pin_f32
    from dispu_tpu_torch.kernels import _build

    pin_f32()
    dev = torch.device("cuda")

    # phase 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = card.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device count {torch.cuda.device_count()}")

    # phase 2
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"built {sorted(seconds)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {', '.join('%s %.1f s' % kv for kv in seconds.items())})")
    for name in _build.NAMES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # phase 3
    aggs = {"knn": check_knn(dev), "fps": check_fps(dev),
            "fps_chunked": check_fps_chunked(dev),
            "attention": check_attention(dev),
            "query_ball": check_query_ball(dev)}
    train_knn = [TRAIN_KNN_MS[k] for k in ("train bb c24", "train bb c48",
                                           "train refiner", "chamfer k1")]
    log(f"kernel ms per train step, by the phase-3 timings: knn "
        f"{train_knn[0] + 3 * train_knn[1] + train_knn[2] + 8 * train_knn[3]:.4f}"
        f" (backbone 1 x {train_knn[0]:.4f} + 3 x {train_knn[1]:.4f}, "
        f"refiner {train_knn[2]:.4f}, chamfer 8 x {train_knn[3]:.4f}), "
        f"attention forward {aggs['attention']['train_fwd_ms']:.4f} + "
        f"backward {aggs['attention']['train_bwd_ms']:.4f}, query_ball "
        f"{aggs['query_ball']['ms']:.4f}")
    # phase 4: each path with its own counts; the JSON line sums them
    counts = add_counts(serve(card), serve_16x(card))
    counts = add_counts(counts, serve_stream(card))
    counts = add_counts(counts, train_phase(card, args.profile))
    if args.profile:
        from dispu_tpu_torch import InferenceConfig
        from dispu_tpu_torch.inference import PatchUpsampler

        for ratio in (4, 16):
            profile_request(
                PatchUpsampler(device="cuda", seed=0,
                               inf_cfg=InferenceConfig(final_ratio=ratio)),
                load_cloud("Icosahedron.xyz"))

    # phase 5: ms, plain_ms, bound_ms and library_ms are per 2048-point
    # request: a 4x request for knn, fps and attention, a 16x request for
    # fps_chunked (its one launch there); per train step for query_ball
    meta = {
        "knn": ("dispu_tpu_torch/kernels/csrc/knn.cu",
                "dispu_tpu/ops/pallas_kernels.py:867"),
        "fps": ("dispu_tpu_torch/kernels/csrc/fps.cu",
                "dispu_tpu/ops/pallas_kernels.py:87"),
        "fps_chunked": ("dispu_tpu_torch/kernels/csrc/fps_chunked.cu",
                        "dispu_tpu/ops/pallas_kernels.py:526, "
                        "dispu_tpu/ops/pallas_kernels.py:471"),
        "attention": ("dispu_tpu_torch/kernels/csrc/attention.cu",
                      "dispu_tpu/ops/pallas_kernels.py:2221"),
        "query_ball": ("dispu_tpu_torch/kernels/csrc/query_ball.cu",
                       "dispu_tpu/ops/pallas_kernels.py:1098"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        a = aggs[name]
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": a["max_abs_err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": "bytes" if a["t_bytes"] >= a["t_ops"]
            else "operations",
            "library_ms": a["library_ms"],
        })
    log(json.dumps({"kernels": line}))
    # phase 6
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
