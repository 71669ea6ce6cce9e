#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --profile  # and where a request's, a train
                                     # step's and a GAN step's time goes

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
     blocks; the turbo path's kernels at its shapes: the fused kNN + gather
     (backbone and refiner, turbo and exact; its distances and indices
     bit-equal to the kNN kernel's), the packed kNN selection (pass 2's
     refiner) and the bucketed merge FPS (4×, 16×, two clouds); the lite
     FPS entry (the critic's seed shape and the 4× merge); the gather
     kernel bit-equal to ``torch.gather`` and the scatter-add kernel
     bit-equal run to run (and to the CPU's ``index_add_``) at the train
     step's gather shapes; ``knn_group``'s backward rule at the backbone's
     and the refiner's train shapes;
  4. drive each serving path at full GeneratorConfig() width from the
     port's own seeded init, on demo/gt/Icosahedron.xyz and
     demo/gt/fandisk.xyz, with the launch counts set to 0 just before each
     path and read just after: 6 whole-cloud 4× requests, 4 whole-cloud 16×
     requests, and ``upsample_many`` of both clouds at 4× and at 16× (twice
     each); compare each path's output with the same path run through the
     plain versions (impl='torch') on the card.  The same for the turbo
     serving configuration (``dispu_tpu_torch.cli.build_config`` of
     ``--phase test --turbo true``): 4× and 16× requests on both clouds
     and ``upsample_many`` of both at 4× and 16×, each beside the exact
     path's Chamfer and time.  Then CD training at the
     same width with the training defaults (batch 28, random input,
     augmentation) on synthetic_patches: ``Trainer.train(epochs=2)`` of 3
     steps an epoch (logs, a checkpoint that restores bit-equal), 20 steps
     on one batch (the loss falls; ms per step), one step through the
     kernels against one through the plain versions (metrics, and a
     gradient at every parameter), and two 5-step runs that must agree
     bit for bit; each run with exact launch counts; the same step with
     ``gather_impl='pallas'`` (the gather pair) and with
     ``fused_grouping`` (``knn_group`` and its backward rule), each
     against the plain versions, repeated bit for bit, and timed beside
     the default step.  ``python -m dispu_tpu_torch.cli --phase test
     --turbo true`` restores the training's checkpoint and upsamples both
     demo clouds into files.  Then GAN training at full width with
     ``dispu.py --use_gan true``'s defaults: ``GANTrainer.train(epochs=2)``
     with a bit-equal restore, 20 steps (ms per step), kernels against
     plain versions (every generator and critic parameter), two bit-equal
     5-step runs, the ``d_clip=0`` game and the critic's fused grouping,
     each with exact launch counts; and the CLI's test phase on the GAN
     log dir (its generator half);
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
# the turbo path through the kernels vs through the plain versions, by
# final ratio: Chamfer over the output's own mean squared nearest-neighbour
# spacing.  The bucketed merge ranks candidates by Morton code, and a
# round-off move across one of its steps shifts bucket seams and seeds
# (see tests/test_torch_turbo.py); at 16× pass 2's near-tie swaps move
# candidates so.  Readings on an H100 at 700 W: 4x 7.1e-12 to 7.9e-12
# (requests and upsample_many); 16x 1.8e-2 to 6.5e-2.
TURBO_CHAMFER_REL = {4: 1e-9, 16: 0.5}


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


def _near_tie_swaps(label, ik, ip, pts, qs, bias, rtol):
    """Rank by rank, the plain distance of the kernel's index must equal
    that of the plain version's index to ``rtol`` of the expansion's
    scale: index differences are swaps between near-ties.  Returns the
    number of differing indices."""
    import torch

    from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

    full = pairwise_sq_dist(qs, pts)
    if bias is not None:
        full = full + bias[:, None, :]
    dk = torch.gather(full, 2, ik.long())
    dp = torch.gather(full, 2, ip.long())
    scale = 2.0 * float(torch.amax(torch.sum(pts * pts, -1)))
    err = float((torch.abs(dk - dp) / (torch.abs(dp) + scale)).max())
    require(err <= rtol, f"{label}: index differs beyond a near-tie ({err})")
    uniq = torch.sort(ik, dim=-1).values
    require(bool(torch.all(uniq[..., 1:] != uniq[..., :-1])),
            f"{label}: repeated index in a row")
    return int((ik != ip).sum())


def check_knn_group(dev):
    """The fused kNN + gather at the turbo path's shapes: the backbone's
    edge gather (drop_first, duplicate bias, features only) of passes 1
    and 2, the refiner's pass-1 grouping (xyz and 128 features) in turbo
    and exact mode.  Its (dists, idx) bit-equal to the kNN kernel's on the
    same inputs; against the plain version, swaps only between near-ties;
    its gathered rows bit-equal to the plain gather (bf16-rounded in turbo
    mode) at its own indices.  The aggregate is a 4× turbo request's."""
    import torch

    from dispu_tpu_torch.kernels.knn import knn_cuda
    from dispu_tpu_torch.kernels.knn_group import (bf16_round,
                                                   knn_group_cuda,
                                                   knn_group_torch)
    from dispu_tpu_torch.ops.knn import mask_duplicate_rows

    gen = torch.Generator(device="cpu").manual_seed(5)

    def feats(b, n, c, n_dup):
        x = torch.randn(b, n, c, generator=gen)
        x[:, n - n_dup:] = x[:, :n_dup]
        return x

    xyz = feats(32, 1024, 3, 0)
    nl = feats(32, 1024, 128, 0)
    # (label, keys, features (None: the keys), k, exact, with_xyz,
    # drop_first and duplicate bias, launches per 4x turbo request)
    cases = [("bbone c24", feats(32, 256, 24, 8), None, 16, False, False,
              True, 1),
             ("bbone c48", feats(32, 256, 48, 8), None, 16, False, False,
              True, 3),
             ("refiner", xyz, nl, 16, False, True, False, 1),
             ("refiner exact", xyz, nl, 16, True, True, False, 0),
             ("p2 bbone c24", feats(32, 1024, 24, 8), None, 16, False, False,
              True, 0),
             ("p2 bbone c48", feats(32, 1024, 48, 8), None, 16, False, False,
              True, 0)]
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    for label, pts, ft, k, exact, with_xyz, drop, per_req in cases:
        pts = pts.contiguous().to(dev)
        ft = pts if ft is None else ft.contiguous().to(dev)
        bias = (mask_duplicate_rows(pts).float() * 1e30) if drop else None
        kw = dict(exact=exact, with_xyz=with_xyz, drop_first=drop)
        d, i, gx, gf = knn_group_cuda(k, pts, pts, ft, bias, **kw)
        kd, ki = knn_cuda(k + drop, pts, pts, bias)
        pd, pi, _, _ = knn_group_torch(k, pts, pts, ft, bias, **kw)
        torch.cuda.synchronize()
        require(torch.equal(d, kd[..., int(drop):])
                and torch.equal(i, ki[..., int(drop):]),
                f"knn_group {label}: (dists, idx) differ from the kNN kernel")
        swaps = _near_tie_swaps(f"knn_group {label}", i, pi, pts, pts, bias,
                                KNN_SWAP_RTOL)
        b, n, c = pts.shape
        cf = ft.shape[-1]
        flat = i.reshape(b, -1, 1).long()
        rows = torch.gather(ft, 1, flat.expand(-1, -1, cf)).reshape(gf.shape)
        require(torch.equal(gf, rows if exact else bf16_round(rows)),
                f"knn_group {label}: gathered rows differ")
        if with_xyz:
            require(torch.equal(gx, torch.gather(
                pts, 1, flat.expand(-1, -1, 3)).reshape(gx.shape)),
                f"knn_group {label}: gathered xyz differ")
        max_abs = float(torch.abs(d - pd).max())
        ms = timed_ms(lambda: knn_group_cuda(k, pts, pts, ft, bias, **kw),
                      reps=20)
        plain_ms = timed_ms(lambda: knn_group_torch(k, pts, pts, ft, bias,
                                                    **kw), reps=5)

        def library():
            dd = torch.cdist(pts, pts) ** 2
            if bias is not None:
                dd = dd + bias[:, None, :]
            ii = torch.topk(dd, k + drop, dim=-1, largest=False)[1]
            ii = ii[..., int(drop):].reshape(b, -1, 1)
            return torch.gather(ft, 1, ii.expand(-1, -1, cf))

        library_ms = timed_ms(library, reps=5)
        m = n
        nbytes = (4 * (2 * b * n * c + (b * n * cf if ft is not pts else 0)
                       + (b * n if drop else 0))
                  + b * m * k * (8 + 4 * cf + (12 if with_xyz else 0)))
        ops = b * m * n * (2 * c + 4)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"knn_group {label:13s} (b={b} n=m={n} c={c} cf={cf} k={k} "
            f"{'exact' if exact else 'turbo'}{' xyz' if with_xyz else ''}"
            f"{' drop_first' if drop else ''}): dists, idx bit-equal to knn; "
            f"rows bit-equal; vs plain: swaps {swaps}, max|d|err "
            f"{max_abs:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cdist+topk+gather {library_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        agg["ms"] += per_req * ms
        agg["plain_ms"] += per_req * plain_ms
        agg["library_ms"] += per_req * library_ms
        agg["bound_ms"] += per_req * bms
        agg["t_bytes"] += per_req * nbytes / HBM_BYTES_PER_S
        agg["t_ops"] += per_req * ops / F32_FLOPS
        agg["max_abs_err"] = max(agg["max_abs_err"], max_abs)
    return agg


def check_knn_packed(dev):
    """The packed kNN selection at pass 2's refiner shape of a 16× turbo
    request, (32, 4096, 3), k = 16: its distances are the kNN kernel's own
    exact distances with the low lane bits cleared, bit for bit, and its
    indices move only at their truncation ties (bench.py's contract);
    against the plain version (cuBLAS distances) swaps only where the
    plain distances agree to one truncation step.  The aggregate is a 16×
    turbo request's one launch."""
    import torch

    from dispu_tpu_torch.kernels.knn import (knn_cuda, knn_packed_cuda,
                                             knn_packed_torch,
                                             packed_lane_bits)

    gen = torch.Generator(device="cpu").manual_seed(6)
    pts = torch.randn(32, 4096, 3, generator=gen).to(dev)
    k = 16
    lb = packed_lane_bits(pts.shape[1])
    step = 2.0 ** -(23 - lb)

    def trunc(x):
        return (x.contiguous().view(torch.int32) & ~((1 << lb) - 1)).view(
            torch.float32)

    d, i = knn_packed_cuda(k, pts, pts)
    ed, ei = knn_cuda(k + 1, pts, pts)
    pd, pi = knn_packed_torch(k, pts, pts)
    torch.cuda.synchronize()
    te = trunc(ed)
    require(torch.equal(d, te[..., :k]),
            "knn_packed: distances are not the exact ones truncated")
    tie = te[..., :k] == te[..., 1:]
    tie[..., 1:] |= te[..., 1:k] == te[..., :k - 1]
    trunc_swaps = int((i != ei[..., :k]).sum())
    require(bool(torch.all((i == ei[..., :k]) | tie)),
            "knn_packed: an index moved away from a truncation tie")
    swaps = _near_tie_swaps("knn_packed", i, pi, pts, pts, None,
                            2 * step + KNN_SWAP_RTOL)
    max_abs = float(torch.abs(d - pd).max())
    b, n, c = pts.shape
    ms = timed_ms(lambda: knn_packed_cuda(k, pts, pts), reps=20)
    plain_ms = timed_ms(lambda: knn_packed_torch(k, pts, pts), reps=5)
    library_ms = timed_ms(lambda: torch.topk(
        torch.cdist(pts, pts) ** 2, k, dim=-1, largest=False), reps=5)
    nbytes = 4 * 2 * b * n * c + 8 * b * n * k
    ops = b * n * n * (2 * c + 4)
    bms, by = bound(nbytes, ops, F32_FLOPS)
    log(f"knn_packed (b={b} n=m={n} c={c} k={k}, {lb} lane bits): distances "
        f"= the kNN kernel's truncated; {trunc_swaps} swaps at truncation "
        f"ties; vs plain: swaps {swaps}, max|d|err {max_abs:.3e}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cdist+topk "
        f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                t_ops=ops / F32_FLOPS, max_abs_err=max_abs)


def check_fps_bucketed(dev):
    """The bucketed merge FPS bit-equal to the plain FPS on each bucket: a
    4× merge of a 2048-point cloud (64 buckets of 384 → 128), a 16× one
    (64 of 1536 → 512), the same for two clouds (one launch), and buckets
    past the register form (3 of 2,500 points).  The aggregate is the 4×
    merge, the kernel's one launch in a 4× turbo request."""
    import torch

    from dispu_tpu_torch.kernels.fps_bucketed import (fps_bucketed_cuda,
                                                      fps_bucketed_torch)

    gen = torch.Generator(device="cpu").manual_seed(7)

    def buckets(k, nb):
        x = torch.randn(k, nb, 3, generator=gen)
        x[:, nb - 10:] = x[:, :10]  # duplicated points
        return x

    cases = [("4x merge", buckets(64, 384), 128, True),
             ("16x merge", buckets(64, 1536), 512, True),
             ("4x stream B=2", buckets(128, 384), 128, True),
             ("16x stream B=2", buckets(128, 1536), 512, True),
             ("device-memory form", buckets(3, 2500), 64, False)]
    agg = None
    for label, x, mb, timed in cases:
        x = x.contiguous().to(dev)
        got = fps_bucketed_cuda(mb, x)
        want, plain_ms = timed_once(lambda: fps_bucketed_torch(mb, x))
        n_diff = int((got != want).sum())
        require(n_diff == 0, f"fps_bucketed {label}: {n_diff} indices differ")
        k, nb, _ = x.shape
        if not timed:
            log(f"fps_bucketed {label} ({k} x {nb} -> {mb}): bit-equal")
            continue
        ms = timed_ms(lambda: fps_bucketed_cuda(mb, x), reps=10)
        nbytes = 12 * k * nb + 4 * k * mb
        ops = 9 * k * nb * (mb - 1)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"fps_bucketed {label} ({k} x {nb} -> {mb}): bit-equal; kernel "
            f"{ms:.4f} ms ({ms / (mb - 1) * 1e3:.3f} us a round), plain "
            f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
        if agg is None:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / F32_FLOPS, max_abs_err=0.0)
    return agg


def check_fps_lite(dev):
    """``fps_lite`` (``fps.cu`` under its own count) bit-equal to the plain
    FPS at the critic's seed shape (28 clouds of 1024 points → 128) and at
    the 4× merge (24,576 → 8,192).  No path calls it, as in the JAX
    package; the aggregate is the critic's shape."""
    import torch

    from dispu_tpu_torch.kernels.fps import fps_lite, fps_torch

    gen = torch.Generator(device="cpu").manual_seed(8)
    merged = torch.randn(1, 24576, 3, generator=gen)
    merged[:, 20000:20100] = merged[:, :100]
    cases = [("critic seeds", torch.randn(28, 1024, 3, generator=gen), 128),
             ("4x merge", merged, 8192)]
    agg = None
    for label, xyz, npoint in cases:
        xyz = xyz.contiguous().to(dev)
        got = fps_lite(npoint, xyz, impl="cuda")
        want, plain_ms = timed_once(lambda: fps_torch(npoint, xyz))
        n_diff = int((got != want).sum())
        require(n_diff == 0, f"fps_lite {label}: {n_diff} indices differ")
        b, n, _ = xyz.shape
        ms = timed_ms(lambda: fps_lite(npoint, xyz, impl="cuda"), reps=5)
        nbytes = 12 * b * n + 4 * b * npoint
        ops = 9 * b * n * (npoint - 1)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"fps_lite {label} (b={b} n={n} -> {npoint}): bit-equal; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
        if agg is None:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / F32_FLOPS, max_abs_err=0.0)
    return agg


# the gather pair's shapes in a train step at batch 28 with
# gather_impl='pallas': (label, n, c, rows gathered per point, launches a
# step): the backbone's first block (c 24) and its three later ones (c 48),
# the refiner's combined [xyz | feature] gather (c 131)
GATHER_CASES = [("backbone c24", 256, 24, 16, 1),
                ("backbone c48", 256, 48, 16, 3),
                ("refiner c131", 1024, 131, 16, 1)]
# the scatter kernel against index_add_ on the card (another sum order):
# |d| over each row's sum of |g|; f32 round-off of sums of a few to a few
# dozen terms
SCATTER_SUM_REL = 1e-6


def _gather_inputs(gen, n, c, per_point, b=28):
    import torch

    table = torch.randn(b, n, c, generator=gen)
    idx = torch.randint(0, n, (b, n * per_point), generator=gen,
                        dtype=torch.int32)
    idx[:, ::per_point] = torch.arange(n, dtype=torch.int32)  # self rows
    return table, idx


def check_gather_rows(dev):
    """The gather kernel bit-equal to ``torch.gather`` at the train step's
    shapes (``GATHER_CASES``); the aggregate is a train step's five
    launches.  The library call is ``torch.gather`` itself, which is also
    the plain version."""
    import torch

    from dispu_tpu_torch.kernels.gather_rows import (gather_rows_cuda,
                                                     gather_rows_torch)

    gen = torch.Generator(device="cpu").manual_seed(9)
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    for label, n, c, per_point, per_step in GATHER_CASES:
        table, idx = _gather_inputs(gen, n, c, per_point)
        table, idx = table.to(dev), idx.to(dev)
        got = gather_rows_cuda(table, idx)
        torch.cuda.synchronize()
        require(torch.equal(got, gather_rows_torch(table, idx)),
                f"gather_rows {label}: rows differ from torch.gather")
        b, q = idx.shape
        flat = idx.long()[..., None].expand(-1, -1, c)
        ms = timed_ms(lambda: gather_rows_cuda(table, idx), reps=20)
        plain_ms = timed_ms(lambda: gather_rows_torch(table, idx), reps=20)
        library_ms = timed_ms(lambda: torch.gather(table, 1, flat), reps=20)
        nbytes = 4 * (b * n * c + b * q + b * q * c)
        bms, by = bound(nbytes, 0, F32_FLOPS)
        log(f"gather_rows {label} (b={b} n={n} c={c} q={q}): bit-equal to "
            f"torch.gather; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.gather {library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("bound_ms", bms)):
            agg[key] += per_step * val
        agg["t_bytes"] += per_step * nbytes / HBM_BYTES_PER_S
    return agg


def check_scatter_rows(dev):
    """The scatter kernel at the train step's shapes (the cotangents of
    ``GATHER_CASES``): bit-equal run to run and to the CPU's sequential
    ``index_add_``, and within ``SCATTER_SUM_REL`` of each row's sum of
    |g| from ``index_add_`` on the card.  Plain: ``index_add_`` on the
    card (atomics); library: ``scatter_add_`` under deterministic
    algorithms (a sort, then ordered sums), the backward of
    ``torch.gather`` that the CD step pays.  The aggregate is a train
    step's five launches."""
    import torch

    from dispu_tpu_torch.kernels.gather_rows import (scatter_rows_cuda,
                                                     scatter_rows_torch)
    from dispu_tpu_torch.train.steps import deterministic

    gen = torch.Generator(device="cpu").manual_seed(10)
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    worst = 0.0
    for label, n, c, per_point, per_step in GATHER_CASES:
        _, idx = _gather_inputs(gen, n, c, per_point)
        b, q = idx.shape
        g_cpu = torch.randn(b, q, c, generator=gen)
        g, idx = g_cpu.to(dev), idx.to(dev)
        got = scatter_rows_cuda(g, idx, n)
        again = scatter_rows_cuda(g, idx, n)
        plain = scatter_rows_torch(g, idx, n)
        torch.cuda.synchronize()
        require(torch.equal(got, again),
                f"scatter_rows {label}: two runs differ")
        require(torch.equal(got.cpu(), scatter_rows_torch(g_cpu, idx.cpu(),
                                                          n)),
                f"scatter_rows {label}: differs from the CPU's index_add_")
        abs_sum = scatter_rows_torch(g.abs(), idx, n)
        rel = float((torch.abs(got - plain) / abs_sum.clamp_min(1e-30))
                    .max())
        worst = max(worst, rel)
        require(rel <= SCATTER_SUM_REL,
                f"scatter_rows {label}: {rel} of the row sums from "
                "index_add_")
        ms = timed_ms(lambda: scatter_rows_cuda(g, idx, n), reps=20)
        plain_ms = timed_ms(lambda: scatter_rows_torch(g, idx, n), reps=20)
        flat = idx.long()[..., None].expand(-1, -1, c)
        zeros = torch.zeros((b, n, c), device=dev)
        with deterministic(dev):
            library_ms = timed_ms(
                lambda: zeros.clone().scatter_add_(1, flat, g), reps=20)
        nbytes = 4 * (b * q * c + b * q + b * n * c)
        bms, by = bound(nbytes, b * q * c, F32_FLOPS)
        log(f"scatter_rows {label} (b={b} q={q} c={c} -> n={n}): bit-equal "
            f"run to run and to the CPU's index_add_; vs index_add_ on the "
            f"card {rel:.2e} of the row sums of |g| (bound "
            f"{SCATTER_SUM_REL}); kernel {ms:.4f} ms, index_add_ "
            f"{plain_ms:.4f} ms, deterministic scatter_add_ {library_ms:.4f} "
            f"ms, bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("bound_ms", bms)):
            agg[key] += per_step * val
        agg["t_bytes"] += per_step * nbytes / HBM_BYTES_PER_S
        agg["t_ops"] += per_step * b * q * c / F32_FLOPS
        agg["max_abs_err"] = max(agg["max_abs_err"],
                                 float(torch.abs(got - plain).max()))
    return agg


# KnnGroupFunction's backward against autograd of the plain distance and
# gathers at the kernel's indices: max |d| over each gradient's max |g|
KNN_GROUP_BWD_REL = 1e-5


def check_knn_group_backward(dev):
    """``KnnGroupFunction``'s backward rule (its gather transposes through
    the scatter kernel) at the train step's shapes: the backbone's aliased
    call (28, 256, c 48, k 16, drop_first, duplicate bias) and the
    refiner's (28 × 1024 points and queries, 128 features, with xyz),
    against autograd of the plain distances and gathers at the kernel's
    own indices (the rule holds the selection fixed)."""
    import torch

    from dispu_tpu_torch.kernels.knn_group import knn_group, rows_at
    from dispu_tpu_torch.ops.knn import mask_duplicate_rows

    gen = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(28, 256, 48, generator=gen)
    x[:, -8:] = x[:, :8]
    cases = [("backbone c48", x, None, True),
             ("refiner", torch.randn(28, 1024, 3, generator=gen),
              torch.randn(28, 1024, 128, generator=gen), False)]
    for label, pts, feats, drop in cases:
        with_xyz = feats is not None

        def leaves():
            p = pts.to(dev).requires_grad_(True)
            f = p if feats is None else feats.to(dev).requires_grad_(True)
            return p, f, [p] if f is p else [p, f]

        p, f, uniq = leaves()
        bias = (mask_duplicate_rows(p.detach()).float() * 1e30 if drop
                else None)
        d, idx, gx, gf = knn_group(16, p, p, f, bias, with_xyz=with_xyz,
                                   drop_first=drop, impl="cuda")
        outs = [t for t in (d, gx, gf) if t is not None]
        cots = [torch.randn(t.shape, generator=gen).to(dev) for t in outs]

        def backward():
            return torch.autograd.grad(outs, uniq, cots, retain_graph=True)

        got = backward()
        bwd_ms = timed_ms(backward, reps=5)
        p, f, uniq2 = leaves()
        nbr = rows_at(p, idx)
        ref = [torch.sum((p[:, :, None, :] - nbr) ** 2, dim=-1)]
        ref += ([nbr] if with_xyz else []) + [rows_at(f, idx)]
        want = torch.autograd.grad(ref, uniq2, cots)
        rels = [float((a - w).abs().max() / w.abs().max())
                for a, w in zip(got, want)]
        require(max(rels) <= KNN_GROUP_BWD_REL,
                f"knn_group backward {label}: {rels}")
        log(f"knn_group backward {label}: gradients vs autograd of the plain "
            f"version at the kernel's indices, max|d|/max|g| "
            f"{['%.2e' % r for r in rels]} (bound {KNN_GROUP_BWD_REL}); "
            f"backward {bwd_ms:.4f} ms")


# --------------------------------------------------------------- phase 4


def expected_counts(up, n: int, b: int = 1) -> dict:
    """Kernel launches of one call of ``up``'s path on b clouds of n points,
    from ``plan_counts`` and the JAX package's shape gates: one seed FPS
    and one patch kNN for all b clouds; per chunk of patches and pass, one
    attention and a kNN in each dense block and in the refiner, each in
    the kernel its gate picks (the fused kNN + gather at n ≤ 2048 with
    ``fused_grouping``, else the packed selection at 64 ≤ n ≤ 4096 with
    ``fast_knn``, else the exact kNN); one merge FPS, bucketed or in the
    kernel that takes its candidates."""
    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.inference import plan_counts
    from dispu_tpu_torch.ops.sampling import fps_kernel_for

    g, inf = up.gen_cfg, up.inf_cfg
    seed_num, out_num = plan_counts(n, inf)
    chunks = -(-b * seed_num // inf.patch_batch)

    def knn_kernel(points, fused_low, k):
        if g.fused_grouping and fused_low <= points <= 2048:
            return "knn_group"
        if g.fast_knn and 64 <= points <= 4096 and k <= 128:
            return "knn_packed"
        return "knn"

    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    counts.update(knn=1, fps=1)
    points = inf.patch_num_point
    for _ in range(up.num_passes):
        # the backbone's gate (edge_parts) starts at 64 points, the
        # refiner's (grouping) at 1
        counts[knn_kernel(points, 64, g.knn + 1)] += g.dense_block * chunks
        points *= g.up_ratio
        counts[knn_kernel(points, 1, g.refine_nsample)] += chunks
        counts["attention"] += chunks
    if inf.merge_fps == "bucketed" and out_num >= inf.merge_fps_buckets:
        counts["fps_bucketed"] += 1
    else:
        counts[fps_kernel_for(seed_num * points)] += 1
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


def turbo_config():
    """The turbo serving configuration, as ``python -m dispu_tpu_torch.cli
    --phase test --turbo true`` builds it."""
    from dispu_tpu_torch import cli

    return cli.build_config(cli.parse_args(["--phase", "test", "--turbo",
                                            "true"]))


def own_spacing2(a, rows: int = 4096) -> float:
    """Mean squared distance from each point of an (n, 3) cloud to its
    nearest other point, on the card, in row blocks."""
    import torch

    a = torch.as_tensor(a).cuda()
    total = 0.0
    for i in range(0, len(a), rows):
        d = torch.cdist(a[i:i + rows], a,
                        compute_mode="donot_use_mm_for_euclid_dist") ** 2
        r = torch.arange(d.shape[0], device=d.device)
        d[r, i + r] = float("inf")
        total += float(d.min(1).values.sum())
    return total / len(a)


def serve_turbo(card: str):
    """The turbo serving configuration at full width from the port's seeded
    init: two 4× and two 16× requests on each demo cloud, then two
    ``upsample_many`` calls of both clouds at each ratio, each path with
    exact launch counts and bit-equal repeats; each output against the
    same path through the plain versions on the card, and beside the
    exact path's output and time."""
    import dataclasses

    import numpy as np
    import torch

    from dispu_tpu_torch import InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler

    cfg = turbo_config()
    clouds = {name: load_cloud(name)
              for name in ("Icosahedron.xyz", "fandisk.xyz")}
    pcs = np.stack(list(clouds.values()))
    b, n, _ = pcs.shape
    total = {}
    for ratio in (4, 16):
        inf = dataclasses.replace(cfg.inference, final_ratio=ratio)
        up = PatchUpsampler(gen_cfg=cfg.generator, inf_cfg=inf, seed=0)
        expected = {}
        for pc in clouds.values():
            expected = add_counts(expected, expected_counts(up, pc.shape[0]),
                                  2)
        outs, times = {}, []
        kernels.reset_launch_counts()
        for name, pc in clouds.items():
            for rep in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = up.upsample(pc)
                times.append((time.perf_counter() - t0) * 1e3)
                require(out.shape == (pc.shape[0] * ratio, 3), out.shape)
                require(np.isfinite(out).all(), f"turbo {name}: non-finite")
                if rep:
                    require(np.array_equal(out, outs[name]),
                            f"turbo {ratio}x {name}: repeated request differs")
                outs[name] = out
        counts = kernels.launch_counts()
        log(f"turbo: launches over 4 {ratio}x requests: {counts} (expected "
            f"{expected})")
        require(counts == expected, f"turbo {ratio}x launch counts {counts}")
        total = add_counts(total, counts)

        expected = add_counts({}, expected_counts(up, n, b), 2)
        many, many_times = [], []
        kernels.reset_launch_counts()
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            many.append(up.upsample_many(pcs))
            many_times.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        log(f"turbo: launches over 2 {ratio}x upsample_many calls (B={b}): "
            f"{counts} (expected {expected})")
        require(counts == expected,
                f"turbo {ratio}x stream launch counts {counts}")
        require(many[0].shape == (b, n * ratio, 3)
                and np.isfinite(many[0]).all()
                and np.array_equal(many[0], many[1]),
                f"turbo {ratio}x stream: shape, values or repeat")
        total = add_counts(total, counts)

        ref = PatchUpsampler(gen_cfg=cfg.generator, inf_cfg=inf, seed=0,
                             impl="torch")
        exact = PatchUpsampler(seed=0, inf_cfg=InferenceConfig(
            final_ratio=ratio))
        exact_ms, rel = [], []
        with torch.inference_mode():
            for name, pc in clouds.items():
                cd = chamfer(outs[name], ref.upsample(pc))
                exact.upsample(pc)  # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ex = exact.upsample(pc)
                exact_ms.append((time.perf_counter() - t0) * 1e3)
                s2 = own_spacing2(outs[name])
                rel.append(cd / s2)
                log(f"turbo {ratio}x {name}: vs the plain turbo path on the "
                    f"card Chamfer {cd:.3e} ({cd / s2:.3e} of the output's "
                    f"own mean squared spacing {s2:.3e}); vs the exact path "
                    f"Chamfer {chamfer(outs[name], ex):.3e}")
            many_ref = ref.upsample_many(pcs)
            for v in range(b):
                cd = chamfer(many[0][v], many_ref[v])
                rel.append(cd / own_spacing2(many[0][v]))
        log(f"turbo {ratio}x: Chamfer vs plain over own spacing, requests "
            f"and upsample_many: {['%.3e' % r for r in rel]} (bound "
            f"{TURBO_CHAMFER_REL[ratio]})")
        require(max(rel) <= TURBO_CHAMFER_REL[ratio],
                f"turbo {ratio}x: Chamfer vs plain {rel}")
        warm = times[1::2]
        log(f"ms per 2048-point {ratio}x turbo request after warm-up: "
            f"{', '.join('%.2f' % t for t in warm)} (first requests "
            f"{', '.join('%.2f' % t for t in times[0::2])}); the exact "
            f"path's {', '.join('%.2f' % t for t in exact_ms)}; "
            f"upsample_many (B={b}) {', '.join('%.2f' % t for t in many_times)}"
            f" (the first warms up); on {card}")
    return total


def cli_phase(card: str, log_dir: str, flags=("--turbo", "true"),
              name: str = "cli_smoke"):
    """``python -m dispu_tpu_torch.cli --phase test`` with ``flags`` on the
    two demo clouds, restoring the newest checkpoint in ``log_dir``: both
    output files exist with n·4 finite rows."""
    import shutil

    import numpy as np

    work = os.path.join(REPO, "chiprun_out", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "in"))
    names = ("Icosahedron", "fandisk")
    for name in names:
        shutil.copy(os.path.join(REPO, "demo", "gt", f"{name}.xyz"),
                    os.path.join(work, "in"))
    cmd = [sys.executable, "-m", "dispu_tpu_torch.cli", "--phase", "test",
           *flags, "--log_dir", log_dir, "--test_data",
           os.path.join(work, "in", "*.xyz"), "--out_folder",
           os.path.join(work, "out")]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    require(out.returncode == 0,
            f"cli test phase exited {out.returncode}: {out.stderr[-3000:]}")
    for name in names:
        n = load_cloud(f"{name}.xyz").shape[0]
        path = os.path.join(work, "out", f"{name}_X4.xyz")
        require(os.path.exists(path), f"cli wrote no {path}")
        rows = np.loadtxt(path, dtype=np.float32)
        require(rows.shape == (n * 4, 3) and np.isfinite(rows).all(),
                f"cli output {path}: {rows.shape}")
    log(f"cli --phase test {' '.join(flags)}: restored {log_dir}, wrote "
        f"{', '.join(f'{n}_X4.xyz' for n in names)} ({seconds:.1f} s with "
        f"the process's start) on {card}")


# ------------------------------------------------------ phase 4: training


def expected_train_counts(cfg) -> dict:
    """Kernel launches of one CD train step, from the configuration and
    the JAX package's gates: a feature-space kNN in each dense block and
    the refiner's xyz kNN, each the fused ``knn_group`` with
    ``fused_grouping`` inside its gate (backbone 64 ≤ n ≤ 2048, refiner
    n ≤ 2048); the chamfer argmin of both directions of the four
    Chamfer/Hausdorff terms (kNN at k = 1: 64 ≤ points ≤ 4096); the NL
    cell's attention (maps of at least 512²); one ball query for the
    repulsion loss.  With ``gather_impl='pallas'`` each block's and the
    refiner's gather inside ``gather_fits`` runs the gather kernel
    forward and the scatter kernel backward; the fused kernel's backward
    scatters the features (and, in the refiner, the xyz)."""
    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.models.generator import DisPUGenerator
    from dispu_tpu_torch.ops.grouping import gather_fits

    g, n_out = cfg.generator, cfg.generator.num_out_points
    n_in = g.num_points
    argmin = 8 if 64 <= n_out <= 4096 else 0
    nl = g.refine and g.use_nonlocal and n_out * n_out >= 512 * 512
    fused_bb = g.fused_grouping and 64 <= n_in <= 2048 and g.knn + 1 <= 128
    fused_ref = g.fused_grouping and g.refine and n_out <= 2048
    model = DisPUGenerator(g, impl="torch")
    widths = [model.feature_extraction_coarse.layer1.l0.dense.in_features
              // 2]
    widths += [getattr(model.feature_extraction_coarse, f"layer{i}_prep")
               .features for i in range(2, g.dense_block + 1)]
    gathers = 0
    if g.gather_impl == "pallas" and not g.fused_grouping:
        gathers = sum(gather_fits(torch.empty(0, n_in, w)) for w in widths)
        if g.refine:
            c = model.PointShuffle.skip.dense.in_features - 6
            gathers += int(gather_fits(torch.empty(0, n_out, 3 + c)))
    return dict(dict.fromkeys(kernels.LAUNCHES, 0),
                knn=(g.dense_block * (not fused_bb)
                     + int(g.refine and not fused_ref) + argmin),
                knn_group=g.dense_block * fused_bb + int(fused_ref),
                attention=int(nl), query_ball=int(cfg.loss.use_repulsion),
                gather_rows=gathers,
                scatter_rows=(gathers + g.dense_block * fused_bb
                              + 2 * fused_ref))


def expected_gan_counts(cfg) -> dict:
    """Kernel launches of one GAN step: the CD step's
    (``expected_train_counts``), the critic's geometry once (an FPS for
    the seeds, a kNN for each of gt and pred at each of the three scales,
    each a ``knn_group`` with the critic's ``fused_grouping`` at clouds of
    at most 2048 points; ball queries with ``knn=False``), again for a
    pooled fake with ``fake_pool_size``, and the ``uniform`` metric (an
    FPS, and a ball query and a kNN for each of its five disk sizes)."""
    d, n_out = cfg.discriminator, cfg.generator.num_out_points
    counts = expected_train_counts(cfg)
    times = 2 if cfg.train.fake_pool_size > 0 else 1
    scales = 2 * len(d.nsample_list)
    kind = ("knn_group" if d.fused_grouping and d.knn and n_out <= 2048
            else "knn" if d.knn else "query_ball")
    counts["fps"] += times + 1
    counts[kind] += times * scales
    counts["query_ball"] += 5
    counts["knn"] += 5
    return counts


def _grads(model) -> dict:
    import torch

    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                ).detach().clone() for n, p in model.named_parameters()}


def compare_steps(label, m_k, g_k, m_p, g_p, extra="", metric_floor=0.0):
    """One step through the kernels against one through the plain
    versions: metrics within ``TRAIN_METRIC_REL`` (of the larger of the
    metric and ``metric_floor`` of the largest one), gradients within
    ``TRAIN_GRAD_REL`` of each leaf's largest, and every parameter with a
    gradient on the plain path has one through the kernels."""
    floor = max(1e-12, metric_floor * max(abs(float(v)) for v in m_p.values()))
    metric_rel = max(abs(float(m_k[k]) - float(m_p[k]))
                     / max(abs(float(m_p[k])), floor) for k in m_p)
    top = max(float(g.abs().max()) for g in g_p.values())
    grad_rel = max(float((g_k[n] - g_p[n]).abs().max())
                   / max(float(g_p[n].abs().max()), 1e-3 * top)
                   for n in g_p)
    dead = sorted(n for n in g_p if bool(g_p[n].abs().max() > 0)
                  and not bool(g_k[n].abs().max() > 0))
    log(f"{label}: one step, kernels vs plain versions on the card: "
        f"metrics max rel {metric_rel:.3e} (bound {TRAIN_METRIC_REL}), "
        f"gradients max |d| / leaf max {grad_rel:.3e} (bound "
        f"{TRAIN_GRAD_REL}); {len(g_p)} parameters, gradient zero through "
        f"the kernels only at {dead}{extra}")
    require(not dead, f"{label}: no gradient through the kernels at {dead}")
    require(metric_rel <= TRAIN_METRIC_REL,
            f"{label}: metrics differ {metric_rel}")
    require(grad_rel <= TRAIN_GRAD_REL,
            f"{label}: gradients differ {grad_rel}")


def require_repeatable(label, make_modules):
    """Two runs from the same state and seed give bit-equal tensors;
    ``make_modules`` runs once and returns the module (or modules) to
    compare."""
    import torch

    def tensors():
        mods = make_modules()
        mods = mods if isinstance(mods, tuple) else (mods,)
        return [t for m in mods for t in m.state_dict().values()]

    a, b = tensors(), tensors()
    n_diff = sum(not torch.equal(x, y) for x, y in zip(a, b))
    log(f"{label}: two runs of 5 steps, tensors that differ: {n_diff} of "
        f"{len(a)}")
    require(n_diff == 0, f"{label}: repeated training differs in {n_diff} "
            "tensors")


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

    def run(impl, steps, seed=0, times=None, c=cfg):
        st = create_generator_state(c.generator, seed=0, impl=impl,
                                    device="cuda")
        step = make_train_step(c, impl=impl)
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
    compare_steps("training", m_k, g_k, m_p, g_p, extra=(
        "; NL cell conv_kv / conv_query max|g| " + ", ".join(
            "%.3e" % float(g_k[n].abs().max()) for n in g_k
            if "nonlocal.conv_kv.dense.weight" in n
            or "nonlocal.conv_query.dense.weight" in n)))

    # (d) two runs of 5 steps from the same state and seed: bit-equal
    require_repeatable("training", lambda: run("auto", 5, seed=3)[0].model)

    # (e) the gather kernels' setting and the fused kNN + gather: exact
    # launch counts of a step through the kernels, then that step against
    # the plain versions, two bit-equal 5-step runs, and ms per warm step
    # beside the default step's, in turns
    variants = {"default": cfg}
    for name, kw in (("gather_impl=pallas", dict(gather_impl="pallas")),
                     ("fused_grouping", dict(fused_grouping=True))):
        vcfg = dataclasses.replace(cfg, generator=dataclasses.replace(
            cfg.generator, **kw))
        variants[name] = vcfg
        kernels.reset_launch_counts()
        st_k, _, m_k = run("auto", 1, c=vcfg)
        counts = kernels.launch_counts()
        want = expected_train_counts(vcfg)
        log(f"training, {name}: launches of one step {counts} (expected "
            f"{want})")
        require(counts == want, f"{name} train launch counts {counts}")
        total_counts = add_counts(total_counts, counts)
        st_p, _, m_p = run("torch", 1, c=vcfg)
        compare_steps(f"training, {name}", m_k, _grads(st_k.model), m_p,
                      _grads(st_p.model))
        kernels.reset_launch_counts()
        require_repeatable(f"training, {name}",
                           lambda: run("auto", 5, seed=3, c=vcfg)[0].model)
        total_counts = add_counts(total_counts, kernels.launch_counts())
    laps = {name: [] for name in variants}
    kernels.reset_launch_counts()
    for _ in range(2):
        for name, vcfg in variants.items():
            times = []
            run("auto", 8, times=times, c=vcfg)
            laps[name] += times[1:]
    total_counts = add_counts(total_counts, kernels.launch_counts())
    log("training: ms per warm step at batch 28, two turns of 7 each: "
        + "; ".join(f"{name} median {statistics.median(t):.3f} (min "
                    f"{min(t):.3f}, max {max(t):.3f})"
                    for name, t in laps.items()) + f"; on {card}")

    log(f"training phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    if profile:
        profile_train_step(cfg, gt, radius)
    return total_counts


# one GAN step through the kernels vs through the plain versions: the CD
# step's limits, each metric against the larger of itself and this share
# of the largest metric (the critic's gap and variance lie near zero)
GAN_METRIC_FLOOR = 1e-3


def gan_phase(card: str, profile: bool):
    """GAN training at full GeneratorConfig() and DiscriminatorConfig()
    width with ``dispu.py --use_gan true``'s defaults (``cli.build_config``:
    d_clip 0.01, gen_update 2, base_lr_d 1e-4), batch 28, on
    synthetic_patches, from the port's seeded init: ``GANTrainer.train
    (epochs=2)`` with a bit-equal checkpoint restore, 20 steps on one
    batch (ms per step), one step through the kernels against one through
    the plain versions (every generator and critic parameter with a
    gradient), two bit-equal 5-step runs, the ``d_clip=0, gen_update=2``
    game over three steps (the critic trains, holds, trains), one step
    with the critic's ``fused_grouping`` and two with a fake pool; each
    with exact launch counts."""
    import dataclasses
    import shutil
    import statistics

    import numpy as np
    import torch

    from dispu_tpu_torch import cli, kernels
    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)
    from dispu_tpu_torch.train.gan_trainer import GANTrainer
    from dispu_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                  restore_checkpoint)
    from dispu_tpu_torch.utils.visu import PointPool

    t_phase = time.perf_counter()
    log_dir = os.path.join(REPO, "chiprun_out", "gan_smoke")
    shutil.rmtree(log_dir, ignore_errors=True)
    base = cli.build_config(cli.parse_args(
        ["--phase", "train", "--use_gan", "true", "--log_dir", log_dir]))
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, epoch_per_save=1, steps_per_print=2))
    bs = cfg.train.batch_size
    per_step = expected_gan_counts(cfg)
    dataset = PatchDataset(h5_path=os.path.join(log_dir, "absent.h5"),
                           synthetic_patches_count=3 * bs, seed=0)

    def tensors(st):
        return ([*st.gen.model.state_dict().values(), *st.gen.mu.values(),
                 *st.gen.nu.values(), *st.disc.state_dict().values(),
                 *st.d_mu.values(), *st.d_nu.values()])

    # (a) GANTrainer: 2 epochs of 3 steps, logs and checkpoints
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state = GANTrainer(cfg, dataset=dataset).train(epochs=2)
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expected = add_counts({}, per_step, 6)
    log(f"GAN training: GANTrainer.train(epochs=2), 6 steps of batch {bs}, "
        f"{trainer_s:.2f} s with set-up; launches {counts} (expected "
        f"{expected})")
    require(counts == expected, f"GAN launch counts {counts}")
    total_counts = counts
    epoch, path = latest_checkpoint(log_dir)
    require(epoch == 2, f"no GAN checkpoint of epoch 2 in {log_dir}")
    back = restore_checkpoint(path, create_gan_state(cfg, seed=11,
                                                     device="cuda"))
    require(all(torch.equal(a, b) for a, b in zip(tensors(state),
                                                  tensors(back)))
            and (back.gen.count, back.d_count, back.step)
            == (state.gen.count, state.d_count, state.step),
            "restored GAN checkpoint differs")
    for line in open(os.path.join(log_dir, "log_train.txt")):
        log("  " + line.rstrip())

    gt = torch.from_numpy(dataset.gt[:bs]).cuda()
    radius = torch.from_numpy(dataset.radius[:bs]).cuda()

    def run(impl, steps, seed=0, times=None, c=cfg):
        st = create_gan_state(c, seed=0, impl=impl, device="cuda")
        step = make_gan_train_step(c, impl=impl)
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

    def grads(st):
        out = {f"generator.{n}": g for n, g in _grads(st.gen.model).items()}
        out.update({f"critic.{n}": g for n, g in _grads(st.disc).items()})
        return out

    # (b) 20 steps on one fixed batch: ms per warm step
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    _, totals, m = run("auto", 20, times=times)
    counts = kernels.launch_counts()
    require(counts == add_counts({}, per_step, 20),
            f"GAN launch counts over 20 steps {counts}")
    total_counts = add_counts(total_counts, counts)
    warm = times[1:]
    log(f"GAN training: 20 steps on one batch: total {totals[0]:.4f} -> "
        f"{totals[-1]:.4f}, d_loss {float(m['d_loss']):.4f}, g_gan "
        f"{float(m['g_gan']):.4f}, d_clip_frac {float(m['d_clip_frac']):.4f}"
        f"; launches {counts}; ms per warm step: median "
        f"{statistics.median(warm):.3f} (min {min(warm):.3f}, max "
        f"{max(warm):.3f}, first step {times[0]:.1f}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; on {card}")
    require(np.isfinite(totals).all() and totals[-1] < totals[0],
            f"GAN loss did not fall: {totals}")

    # (c) one step through the kernels and through the plain versions
    st_k, _, m_k = run("cuda", 1)
    st_p, _, m_p = run("torch", 1)
    compare_steps("GAN training", m_k, grads(st_k), m_p, grads(st_p),
                  metric_floor=GAN_METRIC_FLOOR)

    # (d) two runs of 5 steps from the same state and seed: bit-equal
    kernels.reset_launch_counts()
    require_repeatable("GAN training", lambda: (
        lambda st: (st.gen.model, st.disc))(run("auto", 5, seed=3)[0]))
    total_counts = add_counts(total_counts, kernels.launch_counts())

    # (e) the d_clip = 0 game (the critic trains at step 0, holds at step
    # 1) and the critic's fused kNN + gather, each with exact counts
    game = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, d_clip=0.0, gen_update=2))
    st = create_gan_state(game, seed=0, device="cuda")
    step = make_gan_train_step(game)
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels.reset_launch_counts()
    snaps = []
    for _ in range(3):
        snaps.append([p.detach().clone() for p in st.disc.parameters()])
        st, m = step(st, gt, radius, gen)
    snaps.append([p.detach().clone() for p in st.disc.parameters()])
    counts = kernels.launch_counts()
    require(counts == add_counts({}, expected_gan_counts(game), 3),
            f"d_clip=0 game launch counts {counts}")
    total_counts = add_counts(total_counts, counts)
    moved = [any(not torch.equal(a, b) for a, b in zip(x, y))
             for x, y in zip(snaps, snaps[1:])]
    log(f"GAN training, d_clip=0 gen_update=2: the critic moved at steps "
        f"{[i for i, mv in enumerate(moved) if mv]} of 0..2 (d_count "
        f"{st.d_count}), d_clip_frac {float(m['d_clip_frac'])}, d_gap "
        f"{float(m['d_gap']):.4e}; launches {counts}")
    require(moved == [True, False, True] and st.d_count == 2,
            f"gen_update game: critic moved at {moved}")
    fused = dataclasses.replace(cfg, discriminator=dataclasses.replace(
        cfg.discriminator, fused_grouping=True))
    kernels.reset_launch_counts()
    st_k, _, m_k = run("auto", 1, c=fused)
    counts = kernels.launch_counts()
    require(counts == expected_gan_counts(fused),
            f"fused critic launch counts {counts}")
    total_counts = add_counts(total_counts, counts)
    st_p, _, m_p = run("torch", 1, c=fused)
    compare_steps("GAN training, critic fused_grouping", m_k, grads(st_k),
                  m_p, grads(st_p), metric_floor=GAN_METRIC_FLOOR,
                  extra=f"; launches {counts}")
    # (f) the fake pool's host round trip: two steps with a pool of one
    # batch (the first fills it, the second may swap), each with the
    # critic's geometry of the pooled fake as well
    pooled = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fake_pool_size=1))
    kernels.reset_launch_counts()
    pool = PointPool(1, rng=np.random.RandomState(cfg.train.seed))
    st = create_gan_state(pooled, seed=0, device="cuda")
    step = make_gan_train_step(pooled, fake_pool=pool)
    for _ in range(2):
        st, m = step(st, gt, radius, gen)
    counts = kernels.launch_counts()
    require(counts == add_counts({}, expected_gan_counts(pooled), 2)
            and len(pool.points) == 1 and np.isfinite(float(m["total"])),
            f"fake pool launch counts {counts}")
    total_counts = add_counts(total_counts, counts)
    log(f"GAN training, fake_pool_size=1: two steps, launches {counts}")
    log(f"GAN phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    if profile:
        profile_gan_step(cfg, gt, radius)
    return total_counts, log_dir


def profile_gan_step(cfg, gt, radius):
    """Device time by kernel and the idle share of one warm GAN step under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)

    st = create_gan_state(cfg, device="cuda")
    step = make_gan_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        step(st, gt, radius, gen)
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
    log(f"profiled GAN step: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"wall (unprofiled), idle share {1 - busy / wall_ms:.3f}; "
        f"{sum(n for _, n in by_name.values())} device kernels")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:20]:
        log(f"  {ms:9.3f} ms  x{n:4d}  {name[:110]}")


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

    log(f"profile of one {up.inf_cfg.final_ratio}x request "
        f"({'turbo' if up.gen_cfg.fused_grouping else 'exact'} generator, "
        f"{up.inf_cfg.merge_fps} merge):")
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
    aggs = {"knn": check_knn(dev), "knn_packed": check_knn_packed(dev),
            "knn_group": check_knn_group(dev), "fps": check_fps(dev),
            "fps_chunked": check_fps_chunked(dev),
            "fps_bucketed": check_fps_bucketed(dev),
            "attention": check_attention(dev),
            "query_ball": check_query_ball(dev),
            "fps_lite": check_fps_lite(dev),
            "gather_rows": check_gather_rows(dev),
            "scatter_rows": check_scatter_rows(dev)}
    check_knn_group_backward(dev)
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
    counts = add_counts(counts, serve_turbo(card))
    counts = add_counts(counts, train_phase(card, args.profile))
    cli_phase(card, os.path.join(REPO, "chiprun_out", "train_smoke"))
    gan_counts, gan_dir = gan_phase(card, args.profile)
    counts = add_counts(counts, gan_counts)
    cli_phase(card, gan_dir, ("--use_gan", "true"), "cli_gan_smoke")
    if args.profile:
        import dataclasses

        from dispu_tpu_torch import InferenceConfig
        from dispu_tpu_torch.inference import PatchUpsampler

        turbo = turbo_config()
        for ratio in (4, 16):
            for gen_cfg, inf in (
                    (None, InferenceConfig(final_ratio=ratio)),
                    (turbo.generator, dataclasses.replace(
                        turbo.inference, final_ratio=ratio))):
                kw = {} if gen_cfg is None else dict(gen_cfg=gen_cfg)
                profile_request(PatchUpsampler(seed=0, inf_cfg=inf, **kw),
                                load_cloud("Icosahedron.xyz"))

    # phase 5: ms, plain_ms, bound_ms and library_ms are per 2048-point
    # request: a 4x request for knn, fps and attention, a 16x request for
    # fps_chunked (its one launch there); a 4x turbo request for knn_group
    # and fps_bucketed, a 16x turbo request for knn_packed (its one launch
    # there); per train step for query_ball, and for gather_rows and
    # scatter_rows with gather_impl='pallas' (five launches each); the
    # critic's seed FPS (28 x 1024 -> 128) for fps_lite, which no path
    # calls
    meta = {
        "knn": ("dispu_tpu_torch/kernels/csrc/knn.cu",
                "dispu_tpu/ops/pallas_kernels.py:867"),
        "knn_packed": ("dispu_tpu_torch/kernels/csrc/knn.cu",
                       "dispu_tpu/ops/pallas_kernels.py:867 (variant "
                       "packed, :744)"),
        "knn_group": ("dispu_tpu_torch/kernels/csrc/knn_group.cu",
                      "dispu_tpu/ops/pallas_kernels.py:1791"),
        "fps": ("dispu_tpu_torch/kernels/csrc/fps.cu",
                "dispu_tpu/ops/pallas_kernels.py:87"),
        "fps_chunked": ("dispu_tpu_torch/kernels/csrc/fps_chunked.cu",
                        "dispu_tpu/ops/pallas_kernels.py:526, "
                        "dispu_tpu/ops/pallas_kernels.py:471"),
        "fps_bucketed": ("dispu_tpu_torch/kernels/csrc/fps_bucketed.cu",
                         "dispu_tpu/ops/pallas_kernels.py:631"),
        "attention": ("dispu_tpu_torch/kernels/csrc/attention.cu",
                      "dispu_tpu/ops/pallas_kernels.py:2221"),
        "query_ball": ("dispu_tpu_torch/kernels/csrc/query_ball.cu",
                       "dispu_tpu/ops/pallas_kernels.py:1098"),
        "fps_lite": ("dispu_tpu_torch/kernels/csrc/fps.cu",
                     "dispu_tpu/ops/pallas_kernels.py:211"),
        "gather_rows": ("dispu_tpu_torch/kernels/csrc/gather_rows.cu",
                        "dispu_tpu/ops/pallas_kernels.py:1265"),
        "scatter_rows": ("dispu_tpu_torch/kernels/csrc/gather_rows.cu",
                         "dispu_tpu/ops/pallas_kernels.py:1365"),
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
