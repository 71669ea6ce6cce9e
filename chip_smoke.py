#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --profile  # and where a request's, a train
                                     # step's and a GAN step's time goes

Phases, each of which fails the run (non-zero exit) when it fails:
  1. the card's name and power limit (nvidia-smi) and the CUDA version;
  2. build every kernel from ``dispu_tpu_torch/kernels/csrc`` with nvcc,
     all sources at once, into ``dispu_tpu_torch/_build/``;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the serving paths give it for 2048-point clouds (the 4×
     request, pass 2 of the 16× request, the 16× merge of one cloud and of
     two) and the train step gives it at batch 28 (backbone, refiner and
     chamfer kNN; the attention forward, each shape beside SDPA, and its
     backward rule; the attention's bf16 entry bit-equal to its f32 entry
     at the refiner's shapes and off the tiles; the ball query in all
     three output modes at
     ``kernels/measure.py``'s ``BALL_CASES``: the repulsion loss, the
     critic's ball grouping and the ``uniform`` metric's disks, with no
     synchronization in a call), and time the kernel, the plain version
     and one PyTorch library call for the same function where there is
     one; the exact kNN's radix form in its 'split' regime bit-equal to
     the 'row' regime at n = 20,000 and at the patch cut of a
     60,000-point cloud against the plain version; the cluster FPS kernel also
     past its on-chip capacity, at a ragged n with ties across its
     blocks and at each edge of its forms; the turbo path's kernels at
     its shapes: the fused kNN + gather
     (backbone and refiner, turbo and exact; its distances and indices
     bit-equal to the kNN kernel's), the packed kNN selection (pass 2's
     refiner at k 16, 1 and 32, the row form at k 33; and its
     fixed-selection gradient) and the bucketed merge FPS
     (4×, 16×, two clouds, a 60,000-point cloud's 4× buckets, with µs a
     round); the lite FPS entry (the critic's seed shape and
     the 4× merge); the gather kernel bit-equal to ``torch.gather`` at the
     train step's gather shapes and the scatter-add kernel bit-equal run
     to run (and to the CPU's ``index_add_``) at every scatter of a train
     step with ``gather_impl='pallas'`` and with ``fused_grouping``, each
     with the profiler's device time; ``knn_group``'s
     backward rule at the backbone's and the refiner's train shapes; the
     fused refiner kernels (``refine_local`` on grouped rows,
     ``refine_block`` after ``knn.cu``'s launch of its selection, whose
     indices are held to the plain selection's under the near-tie
     contract) at the refiner's pass-1 and pass-2 shapes and at pass 2 of
     a patch-512 request; each check's wall seconds logged;
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
     path's Chamfer and time, and with ``merge_fps_rank='radix'``
     (``serve_radix``: each output bit-equal to the 4-bit argsort merge
     of its candidates, the rank's ms beside argsort's).  The same for
     ``refine_local_impl``
     'fused' and 'megafused' (two 4× and two 16× requests on each cloud,
     one ``upsample_many`` at each ratio), against the composed path
     ('megafused' at 4× by its generator rows before the merge, and its
     output against the plain merge of its own candidates), timed beside
     'xla'.  Past two kernels' limits: a 4× request on a 60,000-point
     cloud (the patch cut in the 'split' regime, the merge of 719,872
     candidates) twice, bit-equal, and the turbo 4× request on it (the
     bucketed merge's large buckets); 'megafused' at ``patch_num_point`` 512
     and 16× (pass 2's refiner past ``refine_block.cu``'s shared memory
     takes the 'fused' route) against the composed ``fast_gather`` path.
     The serving export (``serve_export``): 4× and 16× exact, 4× turbo
     and 4× 'megafused' exported with ``serving.export_upsampler``, each
     entry loaded by a process that cannot import the model code and
     served bit-equal to the live ``upsample`` with its launch counts;
     export seconds, artifact bytes, and served against live ms per
     request, in turns.  bf16 compute (``serve_bf16``): 4× and 16× exact,
     4× turbo and ``upsample_many`` at ``compute_dtype='bfloat16'``, with
     the JAX gates' launches at bf16 (``attention.cu``'s bf16 entry), f32
     outputs, bit-equal repeats, Chamfer to the plain bf16 path, an
     exported bf16 entry bit-equal to live, and ms beside f32 in turns.
     The SPMD export (``serve_export_mesh``): the 4× and 16× entries
     exported on a one-process NCCL (1, 1) mesh, each with
     ``nr_devices`` 1, the functional all-gather and the mesh-less
     entry's ops in its graph, served bit-equal to the live mesh path and
     to ``serve_export``'s mesh-less entry with live's launches, timed
     against live in turns.  Then CD training at the
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
     the default step; one step with ``refine_local_impl='megafused'``
     (the composed refiner: the default step's launches and metrics).
     ``python -m dispu_tpu_torch.cli --phase test
     --turbo true`` restores the training's checkpoint and upsamples both
     demo clouds into files; ``--phase export`` restores it into an
     artifact that serves both clouds bit-equal to a live upsampler
     restored from the same checkpoint.  Then GAN training at full width with
     ``dispu.py --use_gan true``'s defaults: ``GANTrainer.train(epochs=2)``
     with a bit-equal restore, 20 steps (ms per step), kernels against
     plain versions (every generator and critic parameter), two bit-equal
     5-step runs, the ``d_clip=0`` game and the critic's fused grouping,
     each with exact launch counts; and the CLI's test phase on the GAN
     log dir (its generator half).  bf16 training (``train_bf16``): 10 CD
     and 10 GAN steps at bf16 (the loss falls, every tensor of the state
     f32, kernels against plain versions, bit-equal repeats, ms beside
     f32 in turns).  Training with the turbo flags (``train_turbo``): the
     turbo kernels at a batch-28 step's shapes (``knn_group`` in turbo
     mode, the packed selection), a CD step with every turbo flag, one
     without ``fused_grouping`` and a GAN step with every flag, each with
     exact launch counts, against the plain versions, bit-equal repeats
     and ms beside the exact step in turns; ``remat``
     (``train_remat``): CD (also with ``use_bn``) and GAN steps with
     ``gather_impl='pallas'`` bit-equal to the steps without ``remat``,
     peak memory with and without at batch 28 and 112.  Then the
     evaluation: two shapes of
     the evaluation set made with the port's ``meshgen``, upsampled 4×,
     scored by ``evaluate_dirs`` on the card (1000 disk seeds, timed by
     stage) and by ``python -m dispu_tpu_torch.evaluate``, held against
     the port's plain CPU run, and ``cd_hd`` of the four demo outputs
     (the kNN kernel at k = 1, one launch each).  The host-side
     utilities (``train_utilities``): one CD epoch at batch 28 with
     ``visualize``, ``profile`` and the copy backup, its trace naming the
     kNN, attention and ball-query kernels, its PNG, its state and scalars
     bit-equal to the plain epoch's, and the profiler's cost in turns.
     The point-set ops (``ops_21``): patch extraction, ``dilat_group`` and
     ``three_nn`` through the kernels against the plain versions (near-tie
     swaps only), the EMD against the CPU, and the native host library
     built with g++ and held against ``knn.cu``.  The network modules of
     ROADMAP 21 (``nets_21``): the hierarchy extractor and upsampler, the
     GCN backbone with each conv, the up-projection unit and the ball
     refiner (training, and eval with ``local_impl='fused'``) at their
     published defaults, each with exact launch counts, its selections
     against the plain versions, its output against the plain path on
     the kernels' selections and one backward; the kNN radix form at k 48
     and the hierarchy's ball queries timed.  The last of the JAX
     package (``nets_21b``): ``nn/experimental.py``'s down- and
     up-scalers, ``EdgeConv``, the dense-block variants and the new
     losses at full width, the same way, and their new kernel shapes
     timed;
  5. print one JSON line listing every kernel with its numbers;
  6. print {"ok": true, "device": {...}} as the last line.

Exits non-zero without a result where no CUDA device is available, or
where the repository's package is missing beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
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
TF32_FLOPS = 495e12        # tensor cores, TF32

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
# KnnGroupFunction's backward, and the packed kNN's gradient, against
# autograd of the plain distance and gathers at the kernel's indices: max
# |d| over each gradient's max |g|
KNN_GROUP_BWD_REL = 1e-5
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
# refine_local_impl='megafused' against the composed fast_gather path
# through the kernels at 4x, before the merge: both refiners take knn.cu's
# selection on bit-equal inputs and differ only in the f32 sum order of
# the local branch, so every generator row (patch units) must agree within
# the refine kernels' own 1e-5.  Their outputs are not compared as sets
# here: the exact merge FPS is a chain of argmaxes, and a last-bit move of
# one candidate can change one pick of 8,192 (a Chamfer of ~5e-9, past
# CHAMFER_MAX[4]); instead each output must be bit-equal to the plain merge
# FPS of its own candidates.
MEGA_GEN_ABS = 1e-5


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
    import torch

    from dispu_tpu_torch.kernels.knn import knn_kernel_cuda, knn_torch
    from dispu_tpu_torch.kernels.measure import (KNN_CASES, KNN_WIDE_CASES,
                                                 knn_inputs)
    from dispu_tpu_torch.ops.geometry import (normalize_point_cloud,
                                              pairwise_sq_dist)
    from dispu_tpu_torch.ops.knn import mask_duplicate_rows

    gen = torch.Generator(device="cpu").manual_seed(1)
    cloud, _, _ = normalize_point_cloud(
        torch.from_numpy(load_cloud("Icosahedron.xyz")))
    # measure.KNN_CASES: the shapes of a 4x request (its launches, the
    # aggregate), of a 16x request's second pass and of a train step at
    # batch 28 (backbone, refiner, and the chamfer argmin at k = 1, whose
    # library call is cdist + argmin), checked and timed; then the 'row'
    # regime's other shapes of measure.KNN_WIDE_CASES (the GCN graph at k
    # 48, the patch cut at k 512), outside the aggregate (check_knn_split
    # takes the scan)
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    cases = KNN_CASES + [case for case in KNN_WIDE_CASES
                         if case.queries != "scan"]
    for case, (pts, qs) in zip(cases, knn_inputs(gen, cases, cloud)):
        label, k, dup, per_req = (case.label, case.k, case.dup,
                                  case.per_request)
        pts = pts.to(dev)
        qs = pts if qs is None else qs.to(dev)
        bias = (mask_duplicate_rows(pts).float() * 1e30) if dup else None
        dk, ik = knn_kernel_cuda(k, pts, qs, bias)
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
        ms = timed_ms(lambda: knn_kernel_cuda(k, pts, qs, bias), reps=20)
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
            f"bound {bms:.3g} ms ({by})")
        agg["ms"] += per_req * ms
        agg["plain_ms"] += per_req * plain_ms
        agg["library_ms"] += per_req * library_ms
        agg["bound_ms"] += per_req * bms
        agg["t_bytes"] += per_req * nbytes / HBM_BYTES_PER_S
        agg["t_ops"] += per_req * ops / F32_FLOPS
        agg["max_abs_err"] = max(agg["max_abs_err"], max_abs)
    return agg


def check_fps(dev):
    """The FPS kernel bit-equal to the plain FPS at the 4× request's seed
    FPS (2048 → 24) and merge (24,576 → 8,192), the aggregate; and, timed
    beside them, the critic's (28 × 1024 → 128) and the ``uniform``
    metric's (28 × 1024 → 51) FPS in training, ``upsample_many``'s merge
    of two clouds, and a merge on a lattice, where every round ties."""
    import torch

    from dispu_tpu_torch.kernels.fps import fps_cuda, fps_torch
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    gen = torch.Generator(device="cpu").manual_seed(2)
    cloud, _, _ = normalize_point_cloud(
        torch.from_numpy(load_cloud("fandisk.xyz")))
    merged = torch.randn(1, 24576, 3, generator=gen)
    merged[:, 20000:20100] = merged[:, :100]  # duplicated points
    merged2 = torch.randn(2, 24576, 3, generator=gen)
    merged2[:, 20000:20100] = merged2[:, :100]
    lattice = torch.stack(torch.meshgrid(
        torch.arange(32.0), torch.arange(32.0), torch.arange(24.0),
        indexing="ij"), -1).reshape(1, -1, 3)
    # (label, xyz, npoint, launches per 4x request)
    cases = [("seeds", cloud[None], 24, 1), ("merge", merged, 8192, 1),
             ("critic", torch.randn(28, 1024, 3, generator=gen), 128, 0),
             ("uniform", torch.randn(28, 1024, 3, generator=gen), 51, 0),
             ("merge b2", merged2, 8192, 0),
             ("lattice", lattice, 8192, 0)]
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    for label, xyz, npoint, per_req in cases:
        xyz = xyz.contiguous().to(dev)
        got = fps_cuda(npoint, xyz)
        want, plain_ms = timed_once(lambda: fps_torch(npoint, xyz))
        n_diff = int((got != want).sum())
        require(n_diff == 0, f"fps {label}: {n_diff} indices differ")
        b, n, _ = xyz.shape
        ms = timed_ms(lambda: fps_cuda(npoint, xyz), reps=10)
        nbytes = 12 * b * n + 4 * b * npoint
        ops = 9 * b * n * (npoint - 1)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"fps {label:8s} (b={b} n={n} -> {npoint}): bit-equal; kernel "
            f"{ms:.4f} ms ({ms / (npoint - 1) * 1e3:.3f} us a round), plain "
            f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
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
    (the 16× merge of a 10k-point cloud, cut to 512 samples), (d) n =
    120,000 (the shared-memory form) and (e) a ragged n with tied
    distances across the blocks' index ranges and more samples than
    distinct points; then at each edge of the kernel's forms (a form's
    limit and one past it, ``fps_chunked.forms_from``) with ties between
    the first and the last block.  Times (a), (b) and (d), each with the form
    that ran; the aggregate is (a), the kernel's one launch in a 16×
    request."""
    import torch

    from dispu_tpu_torch.kernels import fps_chunked
    from dispu_tpu_torch.kernels.fps import FPS_MAX_N, fps_torch
    from dispu_tpu_torch.kernels.fps_chunked import (fps_chunked_cuda,
                                                     form_for, forms_from)

    gen = torch.Generator(device="cpu").manual_seed(4)

    def merged(b, n):
        x = torch.randn(b, n, 3, generator=gen)
        x[:, n - 1000:] = x[:, :1000]  # duplicated points
        return x

    n_d = 40003  # 5 blocks of 8001 points, the last one of 7999
    ragged = torch.randn(2, n_d, 3, generator=gen)
    ragged[0] = torch.randn(37, 3, generator=gen).repeat(n_d // 37 + 1, 1)[
        :n_d]  # 37 distinct points, ties in every block
    ragged[1, 8001:8101] = ragged[1, 7901:8001]  # ties across blocks 0 and 1
    # (label, xyz, npoint, timed)
    cases = [("16x merge", merged(1, 98304), 32768, True),
             ("16x stream", merged(2, 98304), 32768, True),
             ("past capacity", merged(1, 479232), 512, False),
             ("n=120000", torch.randn(2, 120000, 3, generator=gen), 256,
              True),
             ("ragged ties", ragged, 64, False)]
    edges = [n for form in forms_from(FPS_MAX_N + 1)[:-1]
             for n in (form.capacity, form.capacity + 1)]
    for i, n in enumerate(edges):
        cases.append((f"edge n={n}", merged(1 + i % 2, n), 96, False))
    agg = None
    for label, xyz, npoint, timed in cases:
        xyz = xyz.contiguous().to(dev)
        got = fps_chunked_cuda(npoint, xyz)
        want, plain_ms = timed_once(lambda: fps_torch(npoint, xyz))
        n_diff = int((got != want).sum())
        require(n_diff == 0, f"fps_chunked {label}: {n_diff} indices differ")
        b, n, _ = xyz.shape
        form = form_for(n)
        if not timed:
            log(f"fps_chunked {label} (b={b} n={n} -> {npoint}; {form}): "
                "bit-equal")
            continue
        ms = timed_ms(lambda: fps_chunked_cuda(npoint, xyz), reps=3,
                      warmup=1)
        nbytes = 12 * b * n + 4 * b * npoint
        ops = 9 * b * n * (npoint - 1)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"fps_chunked {label} (b={b} n={n} -> {npoint}; {form}): "
            f"bit-equal; kernel {ms:.4f} ms ({ms / (npoint - 1) * 1e3:.3f} "
            f"us a round), plain {plain_ms:.4f} ms, bound {bms:.5f} ms "
            f"({by})")
        if agg is None:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / F32_FLOPS, max_abs_err=0.0)
    log("fps_chunked clusters the card holds at once, by (device, form): "
        + ", ".join(f"({d}, {f}): {c}"
                    for (d, f), c in fps_chunked.MAX_CLUSTERS.items()))
    return agg


def check_attention(dev):
    """Kernel (tensor-core ``mma.sync``) vs plain at the NL cell's shapes:
    the 4× request's map (1024 × 1024, counted in the aggregate), pass 2
    of a 16× request (4096 × 4096) and the train step's (28 clouds of
    1024 × 1024), each timed beside SDPA; the backward rule at the train
    shape; and the widths and sizes past those (c = cv = 184 and 256,
    ragged, nk = 8192)."""
    import torch
    import torch.nn.functional as F

    from dispu_tpu_torch.kernels.attention import (attention_cuda,
                                                   attention_torch)

    gen = torch.Generator(device="cpu").manual_seed(3)
    c = 64
    scale = 1.0 / math.sqrt(c)
    agg = None
    for label, b, n in (("4x", 32, 1024), ("pass 2", 32, 4096),
                        ("train", 28, 1024)):
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
                f"attention {label}: max|d| {max_abs}, mean {mean_abs}")
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
        log(f"attention {label} (b={b} nq=nk={n} c=cv={c}): max|d| "
            f"{max_abs:.3e} (bound {ATTN_MAX_ABS}), mean {mean_abs:.3e}, vs "
            f"f32 plain {dev_f32:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
        if agg is None:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / BF16_FLOPS, max_abs_err=max_abs)
        if label == "train":
            agg["train_fwd_ms"] = ms
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
    agg["train_bwd_ms"] = bwd_ms
    log(f"attention train shape (b={bt} nq=nk=1024 c=cv={c}): backward "
        f"(f32 torch ops, map recomputed) {bwd_ms:.4f} ms; dq, dk, dv vs "
        f"autograd of the bf16 plain version: max|d|/max|g| "
        f"{['%.2e' % r for r in rels]} (bound {ATTN_BWD_REL})")
    # the widths past the 4x shape's: c = cv = 184 (fine_extractor=True)
    # and 256, a ragged nq != nk with cv off the tile, and nk = 8192 (the
    # gate's limit); checked here, timed nowhere
    for label, bw, nq, nk, cw, cvw in (("c=cv=184", 4, 1024, 1024, 184, 184),
                                      ("c=cv=256", 2, 1000, 1100, 256, 256),
                                      ("ragged", 3, 700, 650, 64, 40),
                                      ("nk=8192", 2, 512, 8192, 64, 64)):
        qw = torch.randn(bw, nq, cw, generator=gen).to(dev)
        kw = torch.randn(bw, nk, cw, generator=gen).to(dev)
        vw = torch.randn(bw, nk, cvw, generator=gen).to(dev)
        want = attention_torch(qw, kw, vw, cw ** -0.5, bf16_operands=True)
        err = torch.abs(attention_cuda(qw, kw, vw, cw ** -0.5) - want)
        wide, wide_mean = float(err.max()), float(err.mean())
        require(wide <= ATTN_MAX_ABS and wide_mean <= ATTN_MEAN_ABS,
                f"attention {label}: max|d| {wide}, mean {wide_mean}")
        log(f"attention {label} (b={bw} nq={nq} nk={nk} c={cw} cv={cvw}): "
            f"max|d| {wide:.3e} (bound {ATTN_MAX_ABS}), mean "
            f"{wide_mean:.3e}")
    return agg


def check_attention_bf16(dev):
    """The bf16 entry (bf16 q, k, v read where they lie) against the f32
    entry fed the same values upcast, at the refiner's shapes at bf16
    compute: pass 1 of a 4x or 16x request (32 clouds of 1024 x 1024,
    counted in the aggregate) and pass 2 of a 16x one (4096 x 4096), c =
    cv = 64.  The two must be bit-equal: rounding a bf16 value to bf16 is
    the identity, and every later rounding point is shared.  Each entry
    timed, in turns, beside the plain version and SDPA at bf16.  Then
    shapes off the tiles and a misaligned tensor (the entry's padding
    copy), bit-equal too."""
    import torch
    import torch.nn.functional as F

    from dispu_tpu_torch.kernels.attention import (attention_cuda,
                                                   attention_torch)

    gen = torch.Generator(device="cpu").manual_seed(5)
    c = 64
    scale = 1.0 / math.sqrt(c)
    bf16 = torch.bfloat16
    agg = None
    for label, b, n in (("4x", 32, 1024), ("pass 2", 32, 4096)):
        q, k, v = (torch.randn(b, n, c, generator=gen).to(dev).to(bf16)
                   for _ in range(3))
        qf, kf, vf = q.float(), k.float(), v.float()
        got = attention_cuda(q, k, v, scale)
        same = torch.equal(got, attention_cuda(qf, kf, vf, scale))
        want = attention_torch(q, k, v, scale, bf16_operands=True)
        err = torch.abs(got - want)
        max_abs, mean_abs = float(err.max()), float(err.mean())
        require(same, f"attention bf16 entry {label}: not bit-equal to the "
                "f32 entry on the same values")
        require(max_abs <= ATTN_MAX_ABS and mean_abs <= ATTN_MEAN_ABS,
                f"attention bf16 {label}: max|d| {max_abs}, mean {mean_abs}")
        laps = {"bf16": [], "f32": []}
        for _ in range(2):  # in turns
            laps["bf16"].append(timed_ms(
                lambda: attention_cuda(q, k, v, scale), reps=10))
            laps["f32"].append(timed_ms(
                lambda: attention_cuda(qf, kf, vf, scale), reps=10))
        ms, f32_ms = min(laps["bf16"]), min(laps["f32"])
        plain_ms = timed_ms(
            lambda: attention_torch(q, k, v, scale, bf16_operands=True),
            reps=5)
        library_ms = timed_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            reps=5)
        nbytes = 2 * 3 * b * n * c + 4 * b * n * c
        ops = 2 * b * n * n * (c + c)
        bms, by = bound(nbytes, ops, BF16_FLOPS)
        log(f"attention bf16 entry {label} (b={b} nq=nk={n} c=cv={c}): "
            f"bit-equal to the f32 entry: {same}; max|d| vs plain "
            f"{max_abs:.3e} (bound {ATTN_MAX_ABS}), mean {mean_abs:.3e}; "
            f"bf16 entry {ms:.4f} ms ({laps['bf16']}), f32 entry "
            f"{f32_ms:.4f} ms ({laps['f32']}), plain {plain_ms:.4f} ms, "
            f"sdpa bf16 {library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if agg is None:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / BF16_FLOPS, max_abs_err=max_abs,
                       f32_entry_ms=f32_ms)
    for label, bw, nq, nk, cw, cvw, offset in (
            ("ragged", 3, 700, 650, 64, 40, 0),
            ("c=cv=184", 2, 1000, 1100, 184, 184, 0),
            ("misaligned", 2, 1024, 1024, 64, 64, 1)):
        ts = []
        for rows, w in ((nq, cw), (nk, cw), (nk, cvw)):
            x = torch.randn(bw, rows, w, generator=gen).to(dev).to(bf16)
            buf = torch.empty(x.numel() + offset, dtype=bf16, device=dev)
            ts.append(buf[offset:].view(bw, rows, w).copy_(x))
        got = attention_cuda(*ts, cw ** -0.5)
        same = torch.equal(got, attention_cuda(*(t.float() for t in ts),
                                               cw ** -0.5))
        require(same, f"attention bf16 entry {label}: not bit-equal")
        log(f"attention bf16 entry {label} (b={bw} nq={nq} nk={nk} c={cw} "
            f"cv={cvw}, storage offset {offset}): bit-equal to the f32 "
            f"entry")
    return agg


def check_query_ball(dev):
    """Kernel vs plain in all three output modes at ``measure.BALL_CASES``
    (the repulsion loss: 28 clouds of 1024 points, every point a query,
    r = 0.07, nsample 20, select 5; the critic's widest ball grouping;
    the ``uniform`` metric's five disks), under the near-tie contract.
    Times the mode each caller runs (select for the repulsion loss) by
    CUDA events around back-to-back calls (``ms``) and by the profiler's
    device time (``device_ms``), and requires that a call with a Python
    float radius makes no stream synchronization and no host-to-device
    copy (the profiler's CPU trace).  The aggregate is the repulsion
    shape, one launch a CD step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dispu_tpu_torch.kernels.measure import (BALL_CASES, ball_inputs,
                                                 device_ms)
    from dispu_tpu_torch.kernels.query_ball import (query_ball_cuda,
                                                    query_ball_torch)
    from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

    gen = torch.Generator(device="cpu").manual_seed(7)
    agg = None
    for case in BALL_CASES:
        label, r, ns, s = case.label, case.radius, case.nsample, case.select
        xyz, qs = (t.to(dev) for t in ball_inputs(gen, case))
        b, n, c = xyz.shape
        m = qs.shape[1]
        d = pairwise_sq_dist(qs, xyz)                       # (b, m, n)
        scale = (torch.sum(qs * qs, -1)[..., None]
                 + torch.sum(xyz * xyz, -1)[:, None, :])
        r2 = torch.tensor(r, dtype=torch.float32) ** 2
        boundary = torch.any(torch.abs(d - float(r2))
                             <= QB_TIE_RTOL * (float(r2) + scale), dim=-1)
        # the selection is checked at every case, timed where it runs
        sel = s or min(5, ns)
        got = query_ball_cuda(r, ns, xyz, qs, True, sel)
        want = query_ball_torch(r, ns, xyz, qs, True, sel)
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

        def call():
            return query_ball_cuda(r, ns, xyz, qs, False, s)

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        syncs = [evt.name for evt in prof.events()
                 if "Synchronize" in evt.name or "Memcpy" in evt.name]
        require(not syncs, f"ball {label}: a call with a float radius "
                f"synchronizes or copies: {syncs}")
        ms = timed_ms(call, reps=20)
        dev_ms = device_ms(call, reps=20)
        plain_ms = timed_ms(lambda: query_ball_torch(r, ns, xyz, qs, False,
                                                     s), reps=5)
        # the points each query must scan: up to its nsample-th hit
        full = want[1] == ns
        scanned = torch.where(full, want[0][..., -1].long() + 1, n)
        ops = float(scanned.sum()) * (3 * c + 3)
        nbytes = 4 * (b * n * c + b * m * c + b * m * ns + b * m + b * m * s)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"query_ball {label} (b={b} n={n} m={m} c={c} r={r:.4f} "
            f"ns={ns} s={s}): hit-boundary rows {n_boundary}, selection "
            f"near-tie swaps {n_sel}, dists rel err {max_derr:.2e} (bound "
            f"{QB_DIST_RTOL}), mean hits {float(want[1].float().mean()):.2f}"
            f"; no sync or copy a call; kernel {ms:.4f} ms a call, "
            f"{dev_ms:.4f} on the device, plain {plain_ms:.4f} ms, bound "
            f"{bms:.5f} ms ({by})")
        if agg is None:
            agg = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bms,
                       t_bytes=nbytes / HBM_BYTES_PER_S,
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


def check_knn_group(dev, cases=None, per="per_request"):
    """The fused kNN + gather at the turbo path's shapes: the backbone's
    edge gather (drop_first, duplicate bias, features only) of passes 1
    and 2, the refiner's pass-1 grouping (xyz and 128 features) in turbo
    and exact mode.  Its (dists, idx) bit-equal to the kNN kernel's on the
    same inputs; against the plain version, swaps only between near-ties;
    its gathered rows bit-equal to the plain gather (bf16-rounded in turbo
    mode) at its own indices.  ``cases``: ``KNN_GROUP_CASES`` by default;
    the aggregate weighs each case by its field ``per`` (by default a 4×
    turbo request's)."""
    import torch

    from dispu_tpu_torch.kernels.knn import knn_cuda
    from dispu_tpu_torch.kernels.knn_group import (bf16_round,
                                                   knn_group_cuda,
                                                   knn_group_torch)
    from dispu_tpu_torch.kernels.measure import (KNN_GROUP_CASES,
                                                 knn_group_inputs)
    from dispu_tpu_torch.ops.knn import mask_duplicate_rows

    cases = KNN_GROUP_CASES if cases is None else cases
    gen = torch.Generator(device="cpu").manual_seed(5)
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    for case, (pts, ft) in zip(cases, knn_group_inputs(gen, cases)):
        label, k, exact, with_xyz, drop, per_req = (
            case.label, case.k, case.exact, case.with_xyz, case.drop_first,
            getattr(case, per))
        pts = pts.to(dev)
        ft = pts if ft is None else ft.to(dev)
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


def packed_contract(label, k, x, bias=None):
    """The packed selection of each point of ``x`` among ``x`` (with the
    column ``bias``): the kernel's distances are the exact kernel's
    truncated, bit for bit, its indices move only at truncation ties, and
    against the plain version it swaps only where the plain distances
    agree to one truncation step.  Returns (dists, idx, truncation swaps,
    plain swaps, max |d| against the plain distances outside the biased
    columns)."""
    import torch

    from dispu_tpu_torch.kernels.knn import (knn_cuda, knn_packed_cuda,
                                             knn_packed_torch,
                                             packed_lane_bits)

    lbx = packed_lane_bits(x.shape[1])
    step = 2.0 ** -(23 - lbx)
    d, i = knn_packed_cuda(k, x, x, bias)
    ed, ei = knn_cuda(k + 1, x, x, bias)
    pd, pi = knn_packed_torch(k, x, x, bias)
    torch.cuda.synchronize()
    te = (ed.contiguous().view(torch.int32)
          & ~((1 << lbx) - 1)).view(torch.float32)
    require(torch.equal(d, te[..., :k]),
            f"{label}: distances are not the exact ones truncated")
    tie = te[..., :k] == te[..., 1:]
    tie[..., 1:] |= te[..., 1:k] == te[..., :k - 1]
    require(bool(torch.all((i == ei[..., :k]) | tie)),
            f"{label}: an index moved away from a truncation tie")
    swaps = _near_tie_swaps(label, i, pi, x, x, bias,
                            2 * step + KNN_SWAP_RTOL)
    real = d < 1e29  # a biased column's distance is 1e30
    return (d, i, int((i != ei[..., :k]).sum()), swaps,
            float(torch.abs(d - pd)[real].max()))


def check_knn_packed(dev):
    """The packed kNN selection at pass 2's refiner shape of a 16× turbo
    request, (32, 4096, 3), k = 16: its distances are the kNN kernel's own
    exact distances with the low lane bits cleared, bit for bit, and its
    indices move only at their truncation ties (bench.py's contract);
    against the plain version (cuBLAS distances) swaps only where the
    plain distances agree to one truncation step.  The aggregate is a 16×
    turbo request's one launch."""
    import torch

    from dispu_tpu_torch.kernels.knn import (knn_packed, knn_packed_cuda,
                                             knn_packed_torch,
                                             packed_lane_bits)
    from dispu_tpu_torch.kernels.knn_group import rows_at

    gen = torch.Generator(device="cpu").manual_seed(6)
    pts = torch.randn(32, 4096, 3, generator=gen).to(dev)
    k = 16
    lb = packed_lane_bits(pts.shape[1])
    # the tiled form at its edges (k 1 and 32) and the row form past it
    for kk, x in ((1, pts), (32, pts), (33, pts[:2, :1024].contiguous())):
        _, _, t_sw, p_sw, err = packed_contract(f"knn_packed k={kk}", kk, x)
        log(f"knn_packed k={kk} (b={x.shape[0]} n=m={x.shape[1]}): "
            f"distances = the kNN kernel's truncated; {t_sw} swaps at "
            f"truncation ties; vs plain: swaps {p_sw}, max|d|err {err:.3e}")
    d, i, trunc_swaps, swaps, max_abs = packed_contract(
        f"knn_packed k={k}", k, pts)
    # the fixed-selection gradient through the kernel (knn_packed's
    # KnnFunction) against autograd of the plain distances at the kernel's
    # own indices: max |d| over each gradient's max |g|
    wts = torch.randn(d.shape, generator=gen).to(dev)
    leaves = [pts.clone().requires_grad_(True) for _ in range(2)]
    gd, gi = knn_packed(k, *leaves, impl="cuda")
    got = torch.autograd.grad(torch.sum(wts * gd), leaves)
    ref_leaves = [pts.clone().requires_grad_(True) for _ in range(2)]
    nbr = rows_at(ref_leaves[0], gi)
    ref_d = torch.sum((ref_leaves[1][:, :, None, :] - nbr) ** 2, dim=-1)
    want = torch.autograd.grad(torch.sum(wts * ref_d), ref_leaves)
    grad_rels = [float((a - w).abs().max() / w.abs().max())
                 for a, w in zip(got, want)]
    require(max(grad_rels) <= KNN_GROUP_BWD_REL,
            f"knn_packed gradient: {grad_rels}")
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
        f"ties; gradient (points, queries) vs autograd of the plain "
        f"distances at its indices, max|d|/max|g| "
        f"{['%.2e' % r for r in grad_rels]} (bound {KNN_GROUP_BWD_REL}); "
        f"vs plain: swaps {swaps}, max|d|err {max_abs:.3e}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cdist+topk "
        f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                t_ops=ops / F32_FLOPS, max_abs_err=max_abs)


def big_cloud(n: int, seed: int):
    """An (n, 3) f32 cloud on a torus's surface (radii 1 and 0.35) with
    noise, from a numpy seed: a scan-sized input for the patch cut."""
    import numpy as np

    rs = np.random.RandomState(seed)
    u, v = rs.uniform(0.0, 2.0 * np.pi, (2, n))
    ring = 1.0 + 0.35 * np.cos(v)
    pts = np.stack([ring * np.cos(u), ring * np.sin(u), 0.35 * np.sin(v)], 1)
    return (pts + 0.002 * rs.randn(n, 3)).astype(np.float32)


def check_knn_split(dev):
    """The radix form's 'split' regime (k > 32 past the 'row' regime's n,
    the distances recomputed each pass): bit-equal to the 'row' regime at
    n = 20,000 (points repeated: exact ties), with and without a block of
    1e30-biased columns, with the default buffer and with one of 64 pairs
    (more passes over the cloud), both regimes timed there; and the patch
    cut of a 60,000-point cloud (k 256, 703 queries, one in 85 points)
    through the shape gate ``knn_kernel_cuda`` against the plain version
    under ``check_knn``'s contract, timed beside ``cdist`` + ``topk``.
    The aggregate is that cut, one launch a 60,000-point request."""
    import torch

    from dispu_tpu_torch.kernels.knn import (RADIX_CAP, knn_cuda, knn_form,
                                             knn_kernel_cuda, knn_split_cuda,
                                             knn_torch, radix_plan)
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    k = 256
    pts = normalize_point_cloud(torch.from_numpy(
        big_cloud(20000, 3)).to(dev)[None])[0]
    pts[:, 15000:15100] = pts[:, 100:200]
    qs = pts[:, ::85].contiguous()
    bias = torch.zeros(pts.shape[:2], device=dev)
    bias[:, 7000:7300] = 1e30
    for bb in (None, bias):
        want = knn_cuda(k, pts, qs, bb)
        for cap in (None, 64):
            got = knn_split_cuda(k, pts, qs, bb, cap=cap)
            torch.cuda.synchronize()
            require(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]),
                    f"knn_split at n = 20,000 (cap {cap}): not the 'row' "
                    f"regime's bits")
    row_ms = timed_ms(lambda: knn_cuda(k, pts, qs), reps=20)
    split_ms = timed_ms(lambda: knn_split_cuda(k, pts, qs), reps=20)
    log(f"knn_split (n=20000 m={qs.shape[1]} k={k}): bit-equal to the "
        f"'row' regime, with and without a bias, buffers of "
        f"{RADIX_CAP} and 64 pairs; 'row' "
        f"{row_ms:.4f} ms, 'split' {split_ms:.4f} ms")

    n = 60000
    pts = normalize_point_cloud(torch.from_numpy(
        big_cloud(n, 11)).to(dev)[None])[0]
    qs = pts[:, ::85][:, :703].contiguous()
    require(knn_form(k, n, 3) == "split", "knn_split: form at n = 60,000")
    dk, ik = knn_kernel_cuda(k, pts, qs)
    dp, ip = knn_torch(k, pts, qs)
    torch.cuda.synchronize()
    swaps = _near_tie_swaps("knn_split", ik, ip, pts, qs, None,
                            KNN_SWAP_RTOL)
    scale = 2.0 * float(torch.amax(torch.sum(pts * pts, -1)))
    dist_err = float((torch.abs(dk - dp) / (torch.abs(dp) + scale)).max())
    require(dist_err <= KNN_DIST_RTOL, f"knn_split: distance error "
            f"{dist_err}")
    max_abs = float(torch.abs(dk - dp).max())
    m = qs.shape[1]
    ms = timed_ms(lambda: knn_split_cuda(k, pts, qs), reps=20)
    plain_ms = timed_ms(lambda: knn_torch(k, pts, qs), reps=3)
    library_ms = timed_ms(lambda: torch.topk(
        torch.cdist(qs, pts) ** 2, k, dim=-1, largest=False), reps=3)
    nbytes = 4 * (n * 3 + m * 3) + 8 * m * k
    ops = m * n * (2 * 3 + 4)
    bms, by = bound(nbytes, ops, F32_FLOPS)
    plan = radix_plan(k, n, 3, m)
    log(f"knn_split patch cut (n={n} m={m} k={k}, {plan.threads} threads "
        f"a row, a buffer of {plan.cap} pairs): max|d|err {max_abs:.3e} rel "
        f"{dist_err:.2e}, swaps {swaps}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, cdist+topk {library_ms:.4f} ms, bound "
        f"{bms:.3g} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                t_ops=ops / F32_FLOPS, max_abs_err=max_abs)


def check_fps_bucketed(dev):
    """The bucketed merge FPS bit-equal to the plain FPS on each bucket at
    ``measure.BUCKETED_CASES``: the turbo merge of a 2048-point cloud at 4×
    (64 buckets of 384 → 128) and 16× (64 of 1536 → 512), of two clouds
    in one launch at each, and of a 60,000-point cloud at 4× (64 of 11,248 →
    3,750), each timed with µs a round and the form that ran; then
    buckets past the shared-memory form (the device-memory form).  The
    aggregate is the 4× merge, the kernel's one launch in a 4× turbo
    request."""
    import torch

    from dispu_tpu_torch.kernels.fps_bucketed import (fps_bucketed_cuda,
                                                      fps_bucketed_torch,
                                                      form_for, forms_from)
    from dispu_tpu_torch.kernels.measure import (BUCKETED_CASES,
                                                 BucketedCase,
                                                 bucketed_inputs)

    gen = torch.Generator(device="cpu").manual_seed(7)
    past = forms_from(1)[-2].capacity + 1
    cases = [(case, True) for case in BUCKETED_CASES] + [
        (BucketedCase("device-memory form", 3, past, 64, 0), False)]
    agg = None
    for case, timed in cases:
        x = bucketed_inputs(gen, case).contiguous().to(dev)
        mb = case.mb
        got = fps_bucketed_cuda(mb, x)
        want, plain_ms = timed_once(lambda: fps_bucketed_torch(mb, x))
        n_diff = int((got != want).sum())
        require(n_diff == 0,
                f"fps_bucketed {case.label}: {n_diff} indices differ")
        k, nb, _ = x.shape
        form = form_for(nb)
        if not timed:
            log(f"fps_bucketed {case.label} ({k} x {nb} -> {mb}; {form}): "
                "bit-equal")
            continue
        ms = timed_ms(lambda: fps_bucketed_cuda(mb, x), reps=10)
        nbytes = 12 * k * nb + 4 * k * mb
        ops = 9 * k * nb * (mb - 1)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"fps_bucketed {case.label} ({k} x {nb} -> {mb}; {form}): "
            f"bit-equal; kernel {ms:.4f} ms ({ms / (mb - 1) * 1e3:.3f} us a "
            f"round), plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})")
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


# the scatter kernel against index_add_ on the card (another sum order):
# |d| over each row's sum of |g|; f32 round-off of sums of a few to a few
# dozen terms
SCATTER_SUM_REL = 1e-6


def check_gather_rows(dev):
    """The gather kernel bit-equal to ``torch.gather`` at the train step's
    shapes (``measure.GATHER_CASES``); the aggregate is a train step's five
    launches.  The library call is ``torch.gather`` itself, which is also
    the plain version (with the indices widened to int64 first).  ``ms``,
    ``plain_ms`` and ``library_ms`` are CUDA events around back-to-back
    calls, as for every kernel: at the small widths that is the host's
    work a call, which the path pays.  ``device_ms`` and
    ``library_device_ms`` are the profiler's device time of the kernels
    alone."""
    import torch

    from dispu_tpu_torch.kernels.gather_rows import (gather_rows_cuda,
                                                     gather_rows_torch)
    from dispu_tpu_torch.kernels.measure import (GATHER_CASES, device_ms,
                                                 gather_inputs)

    gen = torch.Generator(device="cpu").manual_seed(9)
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               device_ms=0.0, library_device_ms=0.0, t_bytes=0.0,
               t_ops=0.0, max_abs_err=0.0)
    for label, n, c, per_point, per_step in GATHER_CASES:
        table, idx = gather_inputs(gen, n, c, per_point)
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
        dev_ms = device_ms(lambda: gather_rows_cuda(table, idx), reps=20)
        library_dev_ms = device_ms(lambda: torch.gather(table, 1, flat),
                                   reps=20)
        nbytes = 4 * (b * n * c + b * q + b * q * c)
        bms, by = bound(nbytes, 0, F32_FLOPS)
        log(f"gather_rows {label} (b={b} n={n} c={c} q={q}): bit-equal to "
            f"torch.gather; kernel {ms:.4f} ms a call, {dev_ms:.4f} on the "
            f"device ({bms / dev_ms:.1%} of its bound), plain "
            f"{plain_ms:.4f} ms, torch.gather {library_ms:.4f} ms a call, "
            f"{library_dev_ms:.4f} on the device "
            f"({bms / library_dev_ms:.1%}), bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("bound_ms", bms),
                         ("device_ms", dev_ms),
                         ("library_device_ms", library_dev_ms)):
            agg[key] += per_step * val
        agg["t_bytes"] += per_step * nbytes / HBM_BYTES_PER_S
    return agg


def check_scatter_rows(dev):
    """The scatter kernel at every scatter of a train step
    (``measure.SCATTER_CASES``: the gathers' backward with
    ``gather_impl='pallas'``, ``knn_group``'s with ``fused_grouping``):
    bit-equal run to run and to the CPU's sequential ``index_add_``, and
    within ``SCATTER_SUM_REL`` of each row's sum of |g| from
    ``index_add_`` on the card.  Plain: ``index_add_`` on the card
    (atomics); library: ``scatter_add_`` under deterministic algorithms (a
    sort, then ordered sums), the backward of ``torch.gather`` that the
    CD step pays.  ``ms`` by CUDA events around back-to-back calls (at the
    backbone's widths that is the host's work a call), ``device_ms`` the
    profiler's device time of the kernels alone.  The aggregate is a
    ``gather_impl='pallas'`` step's five launches."""
    import torch

    from dispu_tpu_torch.kernels.gather_rows import (scatter_rows_cuda,
                                                     scatter_rows_torch)
    from dispu_tpu_torch.kernels.measure import (SCATTER_CASES, device_ms,
                                                 scatter_inputs)
    from dispu_tpu_torch.train.steps import deterministic

    gen = torch.Generator(device="cpu").manual_seed(10)
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               device_ms=0.0, t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    fused = dict(ms=0.0, device_ms=0.0, bound_ms=0.0)
    for case in SCATTER_CASES:
        g_cpu, idx = scatter_inputs(gen, case)
        b, q, c, n = case.b, case.q, case.c, case.n
        g, idx = g_cpu.to(dev), idx.to(dev)
        got = scatter_rows_cuda(g, idx, n)
        again = scatter_rows_cuda(g, idx, n)
        plain = scatter_rows_torch(g, idx, n)
        torch.cuda.synchronize()
        require(torch.equal(got, again),
                f"scatter_rows {case.label}: two runs differ")
        require(torch.equal(got.cpu(), scatter_rows_torch(g_cpu, idx.cpu(),
                                                          n)),
                f"scatter_rows {case.label}: differs from the CPU's "
                "index_add_")
        abs_sum = scatter_rows_torch(g.abs(), idx, n)
        rel = float((torch.abs(got - plain) / abs_sum.clamp_min(1e-30))
                    .max())
        require(rel <= SCATTER_SUM_REL,
                f"scatter_rows {case.label}: {rel} of the row sums from "
                "index_add_")
        ms = timed_ms(lambda: scatter_rows_cuda(g, idx, n), reps=20)
        dev_ms = device_ms(lambda: scatter_rows_cuda(g, idx, n), reps=20)
        plain_ms = timed_ms(lambda: scatter_rows_torch(g, idx, n), reps=20)
        flat = idx.long()[..., None].expand(-1, -1, c)
        zeros = torch.zeros((b, n, c), device=dev)
        with deterministic(dev):
            library_ms = timed_ms(
                lambda: zeros.clone().scatter_add_(1, flat, g), reps=20)
        nbytes = 4 * (b * q * c + b * q + b * n * c)
        bms, by = bound(nbytes, b * q * c, F32_FLOPS)
        log(f"scatter_rows {case.label} (b={b} q={q} c={c} -> n={n}): "
            f"bit-equal run to run and to the CPU's index_add_; vs "
            f"index_add_ on the card {rel:.2e} of the row sums of |g| "
            f"(bound {SCATTER_SUM_REL}); kernel {ms:.4f} ms a call, "
            f"{dev_ms:.4f} on the device ({bms / dev_ms:.1%} of its bound), "
            f"index_add_ {plain_ms:.4f} ms, deterministic scatter_add_ "
            f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if case.setting == "pallas":
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("bound_ms", bms),
                             ("device_ms", dev_ms)):
                agg[key] += case.per_step * val
            agg["t_bytes"] += case.per_step * nbytes / HBM_BYTES_PER_S
            agg["t_ops"] += case.per_step * b * q * c / F32_FLOPS
        else:
            for key, val in (("ms", ms), ("device_ms", dev_ms),
                             ("bound_ms", bms)):
                fused[key] += case.per_step * val
        agg["max_abs_err"] = max(agg["max_abs_err"],
                                 float(torch.abs(got - plain).max()))
    log(f"scatter_rows a step: gather_impl='pallas' {agg['ms']:.4f} ms by "
        f"events, {agg['device_ms']:.4f} on the device, bound "
        f"{agg['bound_ms']:.4f}; fused_grouping {fused['ms']:.4f} ms, "
        f"{fused['device_ms']:.4f} on the device, bound "
        f"{fused['bound_ms']:.4f}")
    return agg


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


# the fused refiner kernels against their plain versions on the card: every
# output row within this share of max(max |plain output|, 1); 3xTF32 sums
# (f32 grade) in another order than cuBLAS's over K up to 2048 terms
REFINE_REL = 1e-5


def check_refine_local(dev):
    """The fused local + skip kernel against ``refine_local_torch`` on the
    card at the refiner's pass-1 and pass-2 shapes and pass 2 at
    ``patch_num_point`` 512 (``measure``'s ``REFINE_CASES``), on random
    grouped rows and full-width parameters:
    every row within ``REFINE_REL`` of the output's scale.  The aggregate
    is a 4× 'fused' request's one launch (pass 1)."""
    import torch

    from dispu_tpu_torch.kernels.measure import (REFINE_CASES, refine_chain,
                                                 refine_ops, refine_params)
    from dispu_tpu_torch.kernels.refine_local import (LocalParams,
                                                      refine_local_cuda,
                                                      refine_local_torch)

    gen = torch.Generator(device="cpu").manual_seed(12)
    p = LocalParams(*(t.to(dev) for t in refine_params(gen, REFINE_CASES[0])))
    library = refine_chain(p)
    agg = None
    for case in REFINE_CASES:
        b, n, k, cf = case.b, case.n, case.k, 6 + case.c
        g = torch.randn(b, n, k, cf, generator=gen).to(dev)
        got = refine_local_cuda(g, p)
        want = refine_local_torch(g, p)
        again = refine_local_cuda(g, p)
        torch.cuda.synchronize()
        scale = max(float(want.abs().max()), 1.0)
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and err <= REFINE_REL * scale,
                f"refine_local {case.label}: max|d| {err} over scale {scale}")
        require(torch.equal(got, again),
                f"refine_local {case.label}: a repeat differs")
        ms = timed_ms(lambda: refine_local_cuda(g, p), reps=10)
        plain_ms = timed_ms(lambda: refine_local_torch(g, p), reps=5)
        library_ms = timed_ms(lambda: library(g), reps=5)
        nbytes = 4 * (g.numel() + sum(t.numel() for t in p)
                      + b * n * p.wsk.shape[-1])
        ops = refine_ops(case)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"refine_local {case.label} (b={b} n={n} k={k} cf={cf} mlp="
            f"{case.mlp}): max|d| {err:.3e} of scale {scale:.3f} (bound "
            f"{REFINE_REL} of it), a repeat bit-equal; kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"cuBLAS chain {library_ms:.4f} ms, bound {bms:.4f} ms ({by}; "
            f"as 3xTF32 at {TF32_FLOPS / 1e12:.0f} TFLOP/s "
            f"{3 * ops / TF32_FLOPS * 1e3:.4f} ms)")
        if case.per_request:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / F32_FLOPS, max_abs_err=err)
    return agg


def check_refine_block(dev):
    """The mega-fused kernel at the refiner's pass-1 and pass-2 shapes and
    at pass 2 of a patch-512 16× request (8,192 points a patch, past the
    5,195 its selection held before it became knn.cu's launch), on random
    points and features: its selection (``with_idx``, ``knn.cu``'s)
    against the plain version's own (``knn_torch``) under phase 3's
    near-tie contract, its output within ``REFINE_REL`` of the output's
    scale on every row from ``refine_block_torch`` fed those indices; the
    rows that move with the plain version's own selection are counted.
    The plain version and the library call are timed over 5 calls at the
    aggregate's shape and once at the others (its full sorts take tens of
    seconds at 8,192 points).  The aggregate is a 4× 'megafused'
    request's one launch."""
    import torch

    from dispu_tpu_torch.kernels.knn import knn_torch
    from dispu_tpu_torch.kernels.measure import (REFINE_CASES,
                                                 device_ms_by_kernel,
                                                 refine_chain, refine_ops,
                                                 refine_params)
    from dispu_tpu_torch.kernels.refine_block import (grouped_rows,
                                                      refine_block_cuda,
                                                      refine_block_torch)
    from dispu_tpu_torch.kernels.refine_local import LocalParams

    gen = torch.Generator(device="cpu").manual_seed(13)
    p = LocalParams(*(t.to(dev) for t in refine_params(gen, REFINE_CASES[0])))
    library = refine_chain(p)
    agg = None
    for case in REFINE_CASES:
        b, n, k, c = case.b, case.n, case.k, case.c
        xyz = torch.randn(b, n, 3, generator=gen).to(dev)
        feats = torch.randn(b, n, c, generator=gen).to(dev)
        got, idx = refine_block_cuda(xyz, feats, p, with_idx=True)
        want = refine_block_torch(xyz, feats, p, idx=idx)
        # the plain version's kNN sorts whole (b, n, n) rows: in groups of
        # clouds of at most 8 GiB of distances, indices and sorted copies
        per = max(1, (8 << 30) // (16 * n * n))
        groups = [slice(i, i + per) for i in range(0, b, per)]

        def plain():  # refine_block_torch, its selection kept
            sel = torch.cat([knn_torch(k, xyz[g], xyz[g])[1]
                             for g in groups])
            return refine_block_torch(xyz, feats, p, idx=sel), sel

        own, sel = plain()
        torch.cuda.synchronize()
        swaps = sum(_near_tie_swaps(f"refine_block {case.label}", idx[g],
                                    sel[g], xyz[g], xyz[g], None,
                                    KNN_SWAP_RTOL) for g in groups)
        scale = max(float(want.abs().max()), 1.0)
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and err <= REFINE_REL * scale,
                f"refine_block {case.label}: max|d| {err} over scale {scale}")
        moved = int(((got - own).abs().amax(-1) > REFINE_REL * scale).sum())

        def lib():
            sel = torch.topk(torch.cdist(xyz, xyz) ** 2, k, dim=-1,
                             largest=False)[1]
            return library(grouped_rows(xyz, feats, sel))

        ms = timed_ms(lambda: refine_block_cuda(xyz, feats, p), reps=10)
        split = device_ms_by_kernel(lambda: refine_block_cuda(xyz, feats, p),
                                    5)
        reps, warmup = (5, 2) if case.per_request else (1, 0)
        plain_ms = timed_ms(plain, reps=reps, warmup=warmup)
        library_ms = timed_ms(lib, reps=reps, warmup=warmup)
        nbytes = 4 * (xyz.numel() + feats.numel()
                      + sum(t.numel() for t in p) + b * n * p.wsk.shape[-1])
        ops = refine_ops(case) + b * n * n * (2 * 3 + 4)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        tf32_ms = (3 * refine_ops(case) / TF32_FLOPS
                   + b * n * n * (2 * 3 + 4) / F32_FLOPS) * 1e3
        log(f"refine_block {case.label} (b={b} n={n} k={k} c={c} mlp="
            f"{case.mlp}): idx the plain selection's but for {swaps} "
            f"near-tie swaps; device ms by kernel "
            f"{json.dumps(split)}; max|d| {err:.3e} of "
            f"scale {scale:.3f} at those indices (bound {REFINE_REL} of "
            f"it); rows that move with the plain version's own selection "
            f"{moved} of {b * n}; kernel {ms:.4f} ms "
            f"({ops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"cdist+topk+gather+cuBLAS chain {library_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}; the products as 3xTF32 at "
            f"{TF32_FLOPS / 1e12:.0f} TFLOP/s and the selection at f32 "
            f"{tf32_ms:.4f} ms)")
        if case.per_request:
            agg = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                       t_ops=ops / F32_FLOPS, max_abs_err=err)
    return agg


# --------------------------------------------------------------- phase 4


def refine_route(g, points: int, cf: int, dtype: str = "float32"):
    """(the refiner's local-branch route at inference for ``points`` a
    patch and grouped rows of ``cf`` floats, whether 'megafused' fell back
    past its kernel) by the JAX package's gates
    (``dispu_tpu/nn/refine.py``): 'megafused' and 'fused' need no batch
    norm, a three-layer ``refine_mlp`` and f32 compute (``dtype``, the
    compute dtype); 'megafused' also the local
    branch and k ≤ 16, 'fused' points % 128 == 0; otherwise 'xla'.  On
    the card 'megafused' at widths past ``refine_block.cu``'s shared
    memory (``block_fits``; any number of points fits) takes 'fused'
    where points % 128 == 0, else 'xla', grouping by the exact kNN."""
    from dispu_tpu_torch.kernels.refine_block import block_fits

    fusable = not g.use_bn and len(g.refine_mlp) == 3 and dtype == "float32"
    if (g.refine_local_impl == "megafused" and fusable and g.use_local
            and g.refine_nsample <= 16):
        if block_fits(g.refine_nsample, cf, *g.refine_mlp):
            return "megafused", False
        return ("fused" if points % 128 == 0 else "xla"), True
    if g.refine_local_impl == "fused" and fusable and points % 128 == 0:
        return "fused", False
    return "xla", False


def expected_counts(up, n: int, b: int = 1) -> dict:
    """Kernel launches of one call of ``up``'s path on b clouds of n points,
    from ``plan_counts`` and the JAX package's shape gates: one seed FPS
    and one patch kNN for all b clouds (the radix form's 'split' regime
    past the 'row' regime's n); per chunk of patches and pass, one attention and a kNN in
    each dense block and in the refiner, each in the kernel its gate picks
    (the fused kNN + gather at n ≤ 2048 with ``fused_grouping``, else the
    packed selection at 64 ≤ n ≤ 4096 with ``fast_knn``, else the exact
    kNN); the refiner's 'fused' route adds ``refine_local`` to its kNN,
    its 'megafused' route ``refine_block`` after the exact kNN (its
    selection, ``knn.cu``'s launch, whatever the grouping's flags) at any
    number of points (``refine_route``; at widths past that kernel's
    shared memory the exact kNN and ``refine_local`` or the composed
    branch); one merge FPS, bucketed or
    in the kernel that takes its candidates.  At bf16 compute the
    attention is the kernel's bf16 entry (``attention_bf16``) and the
    refiner takes the composed route."""
    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.inference import plan_counts
    from dispu_tpu_torch.kernels.knn import knn_form
    from dispu_tpu_torch.ops.sampling import fps_kernel_for

    g, inf = up.gen_cfg, up.inf_cfg
    seed_num, out_num = plan_counts(n, inf)
    chunks = -(-b * seed_num // inf.patch_batch)
    cf = up.model.PointShuffle.skip.dense.weight.shape[1] if g.refine else 0

    def knn_kernel(points, fused_low, k):
        if g.fused_grouping and fused_low <= points <= 2048:
            return "knn_group"
        if g.fast_knn and 64 <= points <= 4096 and k <= 128:
            return "knn_packed"
        return "knn"

    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    counts[fps_kernel_for(n)] += 1
    split = knn_form(inf.patch_num_point, n, 3) == "split"
    counts["knn_split" if split else "knn"] += 1
    points = inf.patch_num_point
    for _ in range(up.num_passes):
        # the backbone's gate (edge_parts) starts at 64 points, the
        # refiner's (grouping) at 1
        counts[knn_kernel(points, 64, g.knn + 1)] += g.dense_block * chunks
        points *= g.up_ratio
        route, past_block = refine_route(g, points, cf, inf.compute_dtype)
        if route == "megafused":  # knn.cu's selection, then the block
            counts["knn"] += chunks
            counts["refine_block"] += chunks
        elif past_block:  # over 2048 points: no fused grouping kernel
            counts["knn"] += chunks
        else:
            counts[knn_kernel(points, 1, g.refine_nsample)] += chunks
        if route == "fused":
            counts["refine_local"] += chunks
        counts["attention" if inf.compute_dtype == "float32"
               else "attention_bf16"] += chunks
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
        total = add_counts(total, serve_radix(card, cfg, inf, clouds, outs))
    return total


def serve_radix(card: str, cfg, inf, clouds, argsort_outs):
    """The turbo request with ``merge_fps_rank='radix'`` (the merge ranks
    4-bit Morton codes by the counting rank, ``ops.sampling.morton_rank``)
    on each demo cloud, twice: the turbo request's launches, bit-equal
    repeats, and each output bit-equal to the argsort rank's merge at the
    same 4 bits of its own candidates (the rank is stable, so at equal
    bits the buckets are the same); beside the 10-bit argsort request
    (``argsort_outs``), whose buckets split cells finer, its Chamfer over
    the output's own spacing.  At 16× the rank's ms beside the stable
    argsort's at the merge's size.  Returns the requests' launches."""
    import dataclasses

    import numpy as np
    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.ops.sampling import (farthest_point_sample_bucketed,
                                              morton_codes, morton_rank)

    ratio = inf.final_ratio
    rinf = dataclasses.replace(inf, merge_fps_rank="radix")
    up = PatchUpsampler(gen_cfg=cfg.generator, inf_cfg=rinf, seed=0)
    kernels.reset_launch_counts()
    outs, expected = {}, {}
    for name, pc in clouds.items():
        outs[name] = [up.upsample(pc) for _ in range(2)]
        expected = add_counts(expected, expected_counts(up, pc.shape[0]), 2)
    counts = kernels.launch_counts()
    require(counts == expected, f"radix {ratio}x: launch counts {counts} "
            f"(expected {expected})")
    for name, pc in clouds.items():
        out, again = outs[name]
        _, cand, out_num, centroid, furthest = merge_candidates(up, pc[None])
        with torch.inference_mode():
            idx = farthest_point_sample_bucketed(
                out_num, cand, n_buckets=rinf.merge_fps_buckets, bits=4)
            want = torch.gather(cand, 1, idx.long()[..., None].expand(
                -1, -1, 3)) * furthest + centroid
        same = np.array_equal(out, want.cpu().numpy()[0])
        rel = chamfer(out, argsort_outs[name]) / own_spacing2(out)
        log(f"radix {ratio}x {name}: repeat bit-equal "
            f"{np.array_equal(out, again)}; bit-equal to the argsort "
            f"rank's merge at 4 bits of its candidates {same}; against the "
            f"10-bit argsort request Chamfer over own spacing {rel:.3e}")
        require(np.array_equal(out, again) and same and out.shape
                == (pc.shape[0] * ratio, 3) and np.isfinite(out).all(),
                f"radix {ratio}x {name}: output")
    if ratio == 16:
        codes = morton_codes(cand, bits=4)
        n = codes.shape[-1]

        def radix():
            pos = morton_rank(codes, 1 << 12).long()
            return torch.empty_like(pos).scatter_(
                1, pos, torch.arange(n, device=pos.device).expand_as(pos))

        def argsort():
            return torch.argsort(codes, dim=-1, stable=True)

        require(torch.equal(radix(), argsort()),
                "radix rank: not the stable argsort's order")
        log(f"radix rank at the 16x merge's size (n={n}, 4096 codes): "
            f"morton_rank + the permutation scatter "
            f"{timed_ms(radix, reps=20):.4f} ms, stable argsort "
            f"{timed_ms(argsort, reps=20):.4f} ms, in one process on {card}")
    return counts


def serve_refine(card: str):
    """The fused refiner settings (``refine_local_impl`` 'fused' and
    'megafused') at full width from the port's seeded init: two 4× and
    two 16× requests on each demo cloud and one ``upsample_many`` of both
    clouds at each ratio, each path with exact launch counts and
    bit-equal repeats; each output against the composed path within the
    exact path's Chamfer limits: 'fused' against the default 'xla' path
    through the plain versions; 'megafused' against the composed path
    whose refiner gathers its features rounded to bf16 (``fast_gather``,
    whose values it takes; the backbone stays exact) through the kernels,
    so that both take ``knn.cu``'s selection: at 16× by Chamfer, at 4×
    row by row before the merge and then the merge itself
    (:func:`hold_merge_candidates`, ``MEGA_GEN_ABS``).  Against that path
    through the plain versions the two differ where a kNN near-tie falls
    on a selection boundary, as the composed path's kernels and plain
    versions do, so that reading is logged beside the composed path's
    own.  Then ms per request of each setting beside 'xla', in turns."""
    import numpy as np
    import torch

    from dispu_tpu_torch import GeneratorConfig, InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler

    clouds = {name: load_cloud(name)
              for name in ("Icosahedron.xyz", "fandisk.xyz")}
    pcs = np.stack(list(clouds.values()))
    b, n, _ = pcs.shape
    # (reference configuration, its impl)
    refs = {"fused": (GeneratorConfig(), "torch"),
            "megafused": (GeneratorConfig(fast_gather=True), "auto")}
    total = {}
    for ratio in (4, 16):
        inf = InferenceConfig(final_ratio=ratio)
        ups = {"xla": PatchUpsampler(inf_cfg=inf, seed=0)}
        for setting, (ref_cfg, ref_impl) in refs.items():
            up = PatchUpsampler(gen_cfg=GeneratorConfig(
                refine_local_impl=setting), inf_cfg=inf, seed=0)
            ups[setting] = up
            expected = {}
            for pc in clouds.values():
                expected = add_counts(expected,
                                      expected_counts(up, pc.shape[0]), 2)
            outs = {}
            kernels.reset_launch_counts()
            for name, pc in clouds.items():
                for rep in range(2):
                    out = up.upsample(pc)
                    require(out.shape == (pc.shape[0] * ratio, 3)
                            and np.isfinite(out).all(),
                            f"{setting} {ratio}x {name}: shape or values")
                    if rep:
                        require(np.array_equal(out, outs[name]),
                                f"{setting} {ratio}x {name}: repeated "
                                "request differs")
                    outs[name] = out
            counts = kernels.launch_counts()
            log(f"{setting}: launches over 4 {ratio}x requests: {counts} "
                f"(expected {expected})")
            require(counts == expected,
                    f"{setting} {ratio}x launch counts {counts}")
            total = add_counts(total, counts)
            expected = expected_counts(up, n, b)
            kernels.reset_launch_counts()
            many = up.upsample_many(pcs)
            counts = kernels.launch_counts()
            log(f"{setting}: launches of one {ratio}x upsample_many call "
                f"(B={b}): {counts} (expected {expected})")
            require(counts == expected,
                    f"{setting} {ratio}x stream launch counts {counts}")
            require(many.shape == (b, n * ratio, 3)
                    and np.isfinite(many).all(),
                    f"{setting} {ratio}x stream: shape or values")
            total = add_counts(total, counts)

            ref = PatchUpsampler(gen_cfg=ref_cfg, inf_cfg=inf, seed=0,
                                 impl=ref_impl)
            with torch.inference_mode():
                ref_outs = [ref.upsample(pc) for pc in clouds.values()]
                ref_outs += list(ref.upsample_many(pcs))
            got = list(outs.values()) + list(many)
            cds = [chamfer(a, r) for a, r in zip(got, ref_outs)]
            via = "kernels" if ref_impl == "auto" else "plain versions"
            held = setting == "megafused" and ratio == 4
            log(f"{setting} {ratio}x: Chamfer against the composed path "
                f"({'fast_gather' if setting == 'megafused' else 'xla'}) "
                f"through the {via}, requests and upsample_many: "
                f"{['%.3e' % c for c in cds]}"
                + (" (logged; held before the merge below)" if held else
                   f" (bound {CHAMFER_MAX[ratio]})"))
            if not held:
                require(max(cds) <= CHAMFER_MAX[ratio],
                        f"{setting} {ratio}x: Chamfer {cds}")
            if ref_impl == "auto":
                plain = PatchUpsampler(gen_cfg=ref_cfg, inf_cfg=inf, seed=0,
                                       impl="torch")
                if held:
                    hold_merge_candidates(
                        up, ref, plain,
                        [(name, pc[None], outs[name][None])
                         for name, pc in clouds.items()]
                        + [("upsample_many", pcs, many)])
                with torch.inference_mode():
                    p_outs = [plain.upsample(pc) for pc in clouds.values()]
                    p_outs += list(plain.upsample_many(pcs))
                mine = [chamfer(a, r) for a, r in zip(got, p_outs)]
                theirs = [chamfer(a, r) for a, r in zip(ref_outs, p_outs)]
                log(f"{setting} {ratio}x: Chamfer against the same path "
                    f"through the plain versions {['%.3e' % c for c in mine]}"
                    f"; the path's kernels against its plain versions "
                    f"{['%.3e' % c for c in theirs]}")
        pc = clouds["Icosahedron.xyz"]
        laps = {name: [] for name in ups}
        for up in ups.values():
            up.upsample(pc)  # warm
        for turn in range(2):
            order = list(ups) if turn == 0 else list(ups)[::-1]
            for name in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ups[name].upsample(pc)
                laps[name].append((time.perf_counter() - t0) * 1e3)
        log(f"ms per 2048-point {ratio}x request, refine_local_impl in "
            "turns: " + "; ".join(f"{name} {', '.join('%.2f' % t for t in ts)}"
                                  for name, ts in laps.items())
            + f"; on {card}")
    return total


def serve_large(card: str):
    """Past two kernels' limits, at full width from the port's seeded
    init.  A 4× request on a 60,000-point cloud (``big_cloud``): the
    seed FPS and the patch cut (k 256 over 60,000 points: the split row
    form) of 703 patches, 22 generator chunks, the merge of 719,872
    candidates to 240,000 points in ``fps_chunked.cu``'s device-memory
    form; twice, finite, the right shape, bit-equal, with exact launch
    counts.  Then 'megafused' at ``patch_num_point`` 512 and 16× on
    demo/gt/Icosahedron.xyz: both passes' refiners (2,048 and 8,192
    points) in ``refine_block``, no ``refine_local``; twice, with exact
    launch counts, bit-equal, and within
    'megafused''s 16× contract: Chamfer against the composed
    ``fast_gather`` path through the kernels ≤ ``CHAMFER_MAX[16]``.  And
    the turbo 4× request on the same 60,000-point cloud: the bucketed
    merge of its 719,872 candidates in ``fps_bucketed.cu``'s large-bucket
    form (64 buckets of 11,248 points), twice, finite, the right shape,
    bit-equal, with exact launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from dispu_tpu_torch import GeneratorConfig, InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler

    turbo = turbo_config()
    total = {}
    cases = [("4x, 60,000 points", PatchUpsampler(seed=0),
              big_cloud(60000, 11), None),
             ("turbo 4x, 60,000 points", PatchUpsampler(
                 seed=0, gen_cfg=turbo.generator, inf_cfg=dataclasses.replace(
                     turbo.inference, final_ratio=4)),
              big_cloud(60000, 11), None),
             ("megafused 16x, patch 512", PatchUpsampler(
                 gen_cfg=GeneratorConfig(refine_local_impl="megafused"),
                 inf_cfg=InferenceConfig(patch_num_point=512,
                                         final_ratio=16), seed=0),
              load_cloud("Icosahedron.xyz"), GeneratorConfig(
                  fast_gather=True))]
    for label, up, pc, ref_cfg in cases:
        n = pc.shape[0]
        ratio = up.inf_cfg.final_ratio
        expected = add_counts({}, expected_counts(up, n), 2)
        kernels.reset_launch_counts()
        outs, laps = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(up.upsample(pc))
            laps.append((time.perf_counter() - t0) * 1e3)
            require(outs[-1].shape == (n * ratio, 3)
                    and np.isfinite(outs[-1]).all(),
                    f"{label}: shape or values")
        counts = kernels.launch_counts()
        log(f"{label}: launches over 2 requests: {counts} (expected "
            f"{expected}); ms per request {', '.join('%.1f' % t for t in laps)}"
            f" on {card}")
        require(counts == expected, f"{label}: launch counts {counts}")
        if up.gen_cfg.refine_local_impl == "megafused":
            require(counts["refine_block"] > 0
                    and counts["refine_local"] == 0,
                    f"{label}: pass 2's refiner not in refine_block")
        require(np.array_equal(outs[0], outs[1]),
                f"{label}: repeated request differs")
        total = add_counts(total, counts)
        if ref_cfg is not None:
            ref = PatchUpsampler(gen_cfg=ref_cfg, inf_cfg=up.inf_cfg, seed=0)
            with torch.inference_mode():
                cd = chamfer(outs[0], ref.upsample(pc))
            log(f"{label}: Chamfer against the composed fast_gather path "
                f"through the kernels {cd:.3e} (bound {CHAMFER_MAX[ratio]})")
            require(cd <= CHAMFER_MAX[ratio], f"{label}: Chamfer {cd}")
    return total


# the loader process of serve_export: the model code cannot be imported,
# so each entry runs from its artifact, torch and the op registrations
EXPORT_LOADER = r"""
import json, sys, time
for name in ("dispu_tpu_torch.models", "dispu_tpu_torch.nn",
             "dispu_tpu_torch.inference", "dispu_tpu_torch.convert"):
    sys.modules[name] = None
import numpy as np
from dispu_tpu_torch import kernels
from dispu_tpu_torch.serving import ServedUpsampler
pc = np.load(sys.argv[1])
result = {}
for label, path in json.loads(sys.argv[2]).items():
    t0 = time.perf_counter()
    served = ServedUpsampler(path)
    served.warmup()
    load_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    out = served.upsample(pc)
    result[label] = {"counts": kernels.launch_counts(), "load_s": load_s}
    np.save(path + "/served.npy", out)
print(json.dumps({"result": result, "forbidden": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "dispu_tpu"))}))
"""


def serve_export(card: str):
    """The serving export at full width from the port's seeded init, on
    demo/gt/Icosahedron.xyz: 4× and 16× exact, 4× turbo and 4×
    'megafused', each exported (``serving.export_upsampler`` of the live
    upsampler's state dict) into ``chiprun_out/serve_export/``, with its
    seconds and bytes.  One process that cannot import the model code
    (``EXPORT_LOADER``) loads each entry and serves the cloud once: its
    output must be bit-equal to the live ``upsample``, and its launches
    equal ``expected_counts``, as the live call's must.  Then live and
    served requests in turns, ms each."""
    import dataclasses
    import shutil
    import statistics

    import numpy as np
    import torch

    from dispu_tpu_torch import GeneratorConfig, InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.serving import ServedUpsampler, export_upsampler

    t_phase = time.perf_counter()
    work = os.path.join(REPO, "chiprun_out", "serve_export")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    turbo = turbo_config()
    settings = {
        "4x": (GeneratorConfig(), InferenceConfig()),
        "16x": (GeneratorConfig(), InferenceConfig(final_ratio=16)),
        "turbo 4x": (turbo.generator, dataclasses.replace(
            turbo.inference, final_ratio=4)),
        "megafused 4x": (GeneratorConfig(refine_local_impl="megafused"),
                         InferenceConfig()),
    }
    pc = load_cloud("Icosahedron.xyz")
    n = pc.shape[0]
    np.save(os.path.join(work, "pc.npy"), pc)
    total, paths, live, expected, ups = {}, {}, {}, {}, {}
    for label, (gen_cfg, inf_cfg) in settings.items():
        up = PatchUpsampler(gen_cfg=gen_cfg, inf_cfg=inf_cfg, seed=0)
        path = os.path.join(work, label.replace(" ", "_"))
        t0 = time.perf_counter()
        manifest = export_upsampler(up.model.state_dict(), [n], path,
                                    gen_cfg=gen_cfg, inf_cfg=inf_cfg)
        seconds = time.perf_counter() - t0
        entry = manifest["entries"][0]
        nbytes = os.path.getsize(os.path.join(path, entry["file"]))
        expected[label] = expected_counts(up, n)
        kernels.reset_launch_counts()
        live[label] = up.upsample(pc)
        counts = kernels.launch_counts()
        require(counts == expected[label],
                f"{label}: live launches {counts} != {expected[label]}")
        require(sorted(k for k, v in counts.items() if v)
                == entry["kernels"],
                f"{label}: the entry's ops {entry['kernels']} are not the "
                f"kernels the live call launched {counts}")
        log(f"serve_export {label}: exported in {seconds:.2f} s, "
            f"{entry['file']} {nbytes} bytes, ops {entry['kernels']}")
        total = add_counts(total, counts)
        paths[label], ups[label] = path, up

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", EXPORT_LOADER,
         os.path.join(work, "pc.npy"), json.dumps(paths)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=600)
    require(out.returncode == 0,
            f"serve_export loader exited {out.returncode}: "
            f"{out.stderr[-3000:]}")
    report = json.loads(out.stdout.strip().splitlines()[-1])
    require(report["forbidden"] == [],
            f"the loader imported {report['forbidden']}")
    log(f"serve_export: the loader process took "
        f"{time.perf_counter() - t0:.1f} s with its start")
    for label, path in paths.items():
        got = report["result"][label]
        served = np.load(os.path.join(path, "served.npy"))
        require(np.array_equal(served, live[label]),
                f"{label}: served output differs from the live upsample")
        require(got["counts"] == expected[label],
                f"{label}: served launches {got['counts']} != "
                f"{expected[label]}")
        log(f"serve_export {label}: served in a process without the model "
            f"code: bit-equal to live, launches {got['counts']} (= live), "
            f"load and warmup {got['load_s']:.2f} s")
        total = add_counts(total, got["counts"])

    for label, path in paths.items():
        up, served = ups[label], ServedUpsampler(path)
        reps = 3 if up.inf_cfg.final_ratio == 16 else 5
        laps = {"live": [], "served": []}
        for rep in range(reps + 1):  # the first round warms both
            for kind, fn in (("live", up.upsample),
                             ("served", served.upsample)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(pc)  # returns on the host: synchronized
                if rep:
                    laps[kind].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in laps.items()}
        log(f"serve_export {label}: ms per 2048-point request, in turns, "
            f"median of {reps}: live {med['live']:.2f} ("
            f"{', '.join('%.2f' % t for t in laps['live'])}), served "
            f"{med['served']:.2f} ({', '.join('%.2f' % t for t in laps['served'])}"
            f"), served / live {med['served'] / med['live']:.3f} on {card}")
    log(f"serve_export: {time.perf_counter() - t_phase:.1f} s")
    return total


def merge_candidates(up, pcs):
    """``upsample_many``'s stages up to its merge for (B, n, 3) clouds:
    (generator rows (B·s, p·r, 3) in patch units, merge candidates (B,
    N, 3), the output's point count, the clouds' centroid and furthest
    distance)."""
    import numpy as np
    import torch

    from dispu_tpu_torch.inference import plan_counts
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    seed_num, out_num = plan_counts(pcs.shape[1], up.inf_cfg)
    with torch.inference_mode():
        pcs_n, centroid, furthest = normalize_point_cloud(
            torch.from_numpy(np.asarray(pcs, np.float32)).to(up.device))
        patches, p_centroid, p_furthest, _ = up.prepare(pcs_n, seed_num)
        rows = up.generate(patches)
        cand = (rows * p_furthest + p_centroid).reshape(pcs.shape[0], -1, 3)
    return rows, cand, out_num, centroid, furthest


def hold_merge_candidates(up, ref, plain, cases):
    """'megafused' (``up``) against the composed path through the kernels
    (``ref``) before the merge, for each (label, clouds, output of
    ``up``): every generator row within ``MEGA_GEN_ABS``; and the output
    bit-equal to the plain merge FPS (``plain.merge``, the FPS one round
    at a time) of ``up``'s own candidates."""
    import numpy as np
    import torch

    worst = []
    for label, pcs, out in cases:
        rows, cand, out_num, centroid, furthest = merge_candidates(up, pcs)
        rows_ref = merge_candidates(ref, pcs)[0]
        gen = float(torch.abs(rows - rows_ref).amax())
        with torch.inference_mode():
            merged = (plain.merge(cand, out_num) * furthest
                      + centroid).cpu().numpy()
        same = np.array_equal(merged, out)
        log(f"megafused 4x {label}: generator rows against the composed "
            f"path through the kernels: max|d| {gen:.3e} (bound "
            f"{MEGA_GEN_ABS}); output bit-equal to the plain merge FPS of "
            f"its candidates: {same}")
        require(gen <= MEGA_GEN_ABS, f"megafused 4x {label}: generator "
                f"rows max|d| {gen}")
        require(same, f"megafused 4x {label}: output is not the merge of "
                "its candidates")
        worst.append(gen)
    return max(worst)


def cli_phase(card: str, log_dir: str, flags=("--turbo", "true"),
              name: str = "cli_smoke", phase: str = "test"):
    """``python -m dispu_tpu_torch.cli --phase test`` with ``flags`` on the
    two demo clouds, restoring the newest checkpoint in ``log_dir``: both
    output files exist with n·4 finite rows.  With ``phase='export'`` the
    export phase instead, held by :func:`hold_cli_export`, whose launch
    counts it returns."""
    import shutil

    import numpy as np

    work = os.path.join(REPO, "chiprun_out", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "in"))
    names = ("Icosahedron", "fandisk")
    for name in names:
        shutil.copy(os.path.join(REPO, "demo", "gt", f"{name}.xyz"),
                    os.path.join(work, "in"))
    cmd = [sys.executable, "-m", "dispu_tpu_torch.cli", "--phase", phase,
           *flags, "--log_dir", log_dir, "--test_data",
           os.path.join(work, "in", "*.xyz"), "--out_folder",
           os.path.join(work, "out")]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    require(out.returncode == 0,
            f"cli {phase} phase exited {out.returncode}: "
            f"{out.stderr[-3000:]}")
    if phase == "export":
        return hold_cli_export(card, log_dir, flags, names,
                               os.path.join(work, "out"), seconds)
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


def hold_cli_export(card: str, log_dir: str, flags, names, out: str,
                    seconds: float) -> dict:
    """The artifact of ``--phase export`` (one entry, both demo clouds
    have 2048 points) against a live upsampler restored from the same
    checkpoint as the CLI restores it: bit-equal on both clouds, each call
    with ``expected_counts``' launches."""
    import numpy as np

    from dispu_tpu_torch import cli, kernels
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.serving import ServedUpsampler

    cfg = cli.build_config(cli.parse_args(
        ["--phase", "export", *flags, "--log_dir", log_dir]))
    up = PatchUpsampler(gen_cfg=cfg.generator, inf_cfg=cfg.inference, seed=0)
    up.model.load_state_dict(cli.restore_generator_weights(cfg, up.device))
    served = ServedUpsampler(out)
    require(served.sizes == [2048], f"cli export sizes {served.sizes}")
    kernels.reset_launch_counts()
    for name in names:
        pc = load_cloud(f"{name}.xyz")
        require(np.array_equal(served.upsample(pc), up.upsample(pc)),
                f"cli export: served {name} differs from the live upsample")
    counts = kernels.launch_counts()
    expected = add_counts({}, expected_counts(up, 2048), 2 * len(names))
    require(counts == expected, f"cli export launches {counts} != {expected}")
    log(f"cli --phase export{''.join(' ' + f for f in flags)}: restored "
        f"{log_dir}, wrote "
        f"{out} ({seconds:.1f} s with the process's start); served = live "
        f"on {', '.join(names)}, launches {counts} on {card}")
    return counts


# ---------------------------------------------------- phase 4: evaluation

# the evaluation on the card against the port's plain CPU run: CD and HD
# relative (the card's kNN kernel or cuBLAS argmin against the CPU's, so
# near-tie swaps and sum orders apart; tests/test_torch_eval.py's bound
# against JAX), the point-to-face distances absolute on the unit-scale
# meshes (the sums of three products may round apart)
EVAL_CD_REL = 1e-5
EVAL_P2F_ABS = 1e-6
EVAL_CPU_POINTS = 2048     # points of each prediction scanned on the CPU too
HELDOUT_SEED = 7_777_777   # scripts/build_heldout.py's evaluation set
EVAL_STAGES = (("cd_hd", "cd_hd"), ("point_to_mesh_distance", "P2F"),
               ("geodesic_distances", "geodesic"),
               ("uniformity_measure", "uniformity"), ("evaluate_pair", "pair"))


def evaluate_phase(card: str) -> dict:
    """The port's evaluation path on the card, as ``evaluate.py`` scores a
    directory.  Two shapes of the evaluation set (``make_corpus(2,
    seed=7_777_777)``, gt 8192 and input 2048 points by Poisson-disk
    sampling, as ``scripts/build_heldout.py`` builds it) written under
    ``chiprun_out/eval_smoke/``; the 4× ``PatchUpsampler`` (seeded init)
    on the inputs; ``evaluate_dirs(device='cuda')`` with 1000 disk seeds,
    timed by stage; the same directories through ``python -m
    dispu_tpu_torch.evaluate --disk_seeds 100`` (its CD, hausdorff and p2f
    equal to the in-process run's); CD/HD and the point-to-face distances
    held against the port's plain CPU run; ``cd_hd`` of the four demo
    outputs against ``demo/gt`` (the kNN kernel's direction) against the
    plain argmin on the card, printed beside the tracked
    ``demo/outputs/evaluation.csv`` (a TPU's, for information).  The kNN
    launches must be the gate's: none for a pair with an 8192-point gt,
    one for each demo pair.  Returns the phase's launch counts."""
    import csv

    import numpy as np
    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.data.meshgen import make_corpus, poisson_disk_sample
    from dispu_tpu_torch.evaluation import metrics, report
    from dispu_tpu_torch.evaluation.meshio import (read_off, read_xyz,
                                                   write_off, write_xyz)
    from dispu_tpu_torch.inference import PatchUpsampler

    t_phase = time.perf_counter()
    root = os.path.join(REPO, "chiprun_out", "eval_smoke")
    dirs = {sub: os.path.join(root, sub)
            for sub in ("input", "gt", "mesh", "pred")}
    for path in dirs.values():
        os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    names = []
    for name, (verts, faces) in make_corpus(2, seed=HELDOUT_SEED):
        name = "ho_" + name
        gt = poisson_disk_sample(verts, faces, 8192, seed=HELDOUT_SEED + 1)
        inp = poisson_disk_sample(verts, faces, 2048, seed=HELDOUT_SEED + 2)
        write_xyz(os.path.join(dirs["input"], name + ".xyz"), inp)
        write_xyz(os.path.join(dirs["gt"], name + ".xyz"), gt)
        write_off(os.path.join(dirs["mesh"], name + ".off"), verts, faces)
        names.append(name)
        log(f"evaluation set: {name}: {len(verts)} vertices, {len(faces)} "
            f"faces, gt {gt.shape}, input {inp.shape}")
    log(f"evaluation set made in {time.perf_counter() - t0:.1f} s")

    up = PatchUpsampler(device="cuda", seed=0)
    for name in names:
        out = up.upsample(read_xyz(os.path.join(dirs["input"],
                                                name + ".xyz"))[:, :3])
        require(out.shape == (8192, 3) and np.isfinite(out).all(),
                f"{name}: upsampled {out.shape}")
        write_xyz(os.path.join(dirs["pred"], name + "_X4.xyz"), out)

    # evaluate_dirs with each stage's function wrapped in a synchronized
    # timer (report's own names: it imported them)
    stage_ms = {label: [] for _, label in EVAL_STAGES}

    def timed(fn, label):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_ms[label].append((time.perf_counter() - t) * 1e3)
            return out
        return call

    saved = {attr: getattr(report, attr) for attr, _ in EVAL_STAGES}
    for attr, label in EVAL_STAGES:
        setattr(report, attr, timed(saved[attr], label))
    kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        summary = report.evaluate_dirs(dirs["pred"], dirs["gt"],
                                       mesh_dir=dirs["mesh"], device="cuda")
        wall = time.perf_counter() - t0
    finally:
        for attr, fn in saved.items():
            setattr(report, attr, fn)
    counts = kernels.launch_counts()
    log(f"evaluate_dirs (1000 disk seeds, 2 pairs): {wall:.2f} s; launches "
        f"{counts}; stage ms a pair: " + "; ".join(
            f"{label} " + ", ".join("%.1f" % ms for ms in times)
            for label, times in stage_ms.items()) + f" on {card}")
    require(all(n == 0 for n in counts.values()),
            f"evaluate_dirs with 8192-point gt clouds launched {counts}: "
            f"the gate admits no kernel there")
    require(all(len(t) == 2 for t in stage_ms.values()),
            f"stages timed {[len(t) for t in stage_ms.values()]}")

    def read_rows(path):
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        require(len(rows) == len(names) + 1 and rows[-1]["name"] == "-",
                f"{path}: rows {[r['name'] for r in rows]}")
        for row in rows:
            require(len(row) == 7 and all(
                np.isfinite(float(v)) for k, v in row.items() if k != "name"),
                f"{path}: row {row}")
        return rows

    rows = read_rows(os.path.join(dirs["pred"], "evaluation.csv"))
    require({k: float(v) for k, v in rows[-1].items() if k != "name"}
            == summary, "evaluation.csv's summary row is not the summary")
    for row in rows:
        log("evaluation.csv: " + ", ".join(f"{k} {v}" for k, v in
                                           row.items()))

    cli_csv = os.path.join(root, "cli_evaluation.csv")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "dispu_tpu_torch.evaluate", "--pred",
         dirs["pred"], "--gt", dirs["gt"], "--mesh", dirs["mesh"],
         "--disk_seeds", "100", "--out_csv", cli_csv],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    require(out.returncode == 0, f"python -m dispu_tpu_torch.evaluate "
            f"exited {out.returncode}: {out.stderr[-3000:]}")
    printed = json.loads(out.stdout)
    cli_rows = read_rows(cli_csv)
    require({k: float(v) for k, v in cli_rows[-1].items() if k != "name"}
            == printed, "the CLI's summary is not its CSV's summary row")
    for row, cli_row in zip(rows, cli_rows):
        for key in ("name", "CD", "hausdorff", "p2f avg", "p2f std"):
            require(row[key] == cli_row[key],
                    f"CLI {key} {cli_row[key]} != in-process {row[key]}")
    log(f"python -m dispu_tpu_torch.evaluate --disk_seeds 100: "
        f"{time.perf_counter() - t0:.1f} s with the process's start; CD, "
        f"hausdorff and p2f equal to the in-process run; uniform "
        + ", ".join(f"{r['uniform_0']}/{r['uniform_1']}" for r in cli_rows))

    # the card against the port's plain CPU run
    by_name = {row["name"]: row for row in rows}
    for name in names:
        row = by_name[name + "_X4.xyz"]
        pred = read_xyz(os.path.join(dirs["pred"], name + "_X4.xyz"))[:, :3]
        gt = read_xyz(os.path.join(dirs["gt"], name + ".xyz"))[:, :3]
        cpu = [float(x) for x in metrics.cd_hd(torch.from_numpy(pred),
                                               torch.from_numpy(gt))]
        card_cd_hd = [float(row["CD"]), float(row["hausdorff"])]
        rel = max(abs(a - b) / abs(b) for a, b in zip(card_cd_hd, cpu))
        verts, faces = read_off(os.path.join(dirs["mesh"], name + ".off"))
        d_card, p_card = metrics.point_to_mesh_distance(pred, verts, faces)
        require(float(np.nanmean(d_card)) == float(row["p2f avg"]),
                f"{name}: P2F on the card {float(np.nanmean(d_card))} != "
                f"the report's {row['p2f avg']}")
        t0 = time.perf_counter()
        d_cpu, _ = metrics.point_to_mesh_distance(
            pred[:EVAL_CPU_POINTS], verts, faces, device="cpu")
        cpu_s = time.perf_counter() - t0
        p2f_err = float(np.abs(d_card[:EVAL_CPU_POINTS] - d_cpu).max())
        log(f"{name}: card vs CPU: CD/HD {card_cd_hd} vs {cpu}, rel "
            f"{rel:.2e} (bound {EVAL_CD_REL}); P2F of {EVAL_CPU_POINTS} "
            f"points max|d| {p2f_err:.2e} (bound {EVAL_P2F_ABS}; the CPU "
            f"scan {cpu_s:.1f} s)")
        require(rel <= EVAL_CD_REL, f"{name}: CD/HD card vs CPU {rel}")
        require(p2f_err <= EVAL_P2F_ABS, f"{name}: P2F card vs CPU {p2f_err}")

    # the demo outputs: the gate's kernel direction (gt 2048 points)
    with open(os.path.join(REPO, "demo", "outputs", "evaluation.csv"),
              newline="") as f:
        tracked = {row["name"]: row for row in csv.DictReader(f)}
    kernels.reset_launch_counts()
    demo = {}
    for name in ("Icosahedron_X4", "Icosahedron_X16", "fandisk_X4",
                 "fandisk_X16"):
        pred = torch.from_numpy(read_xyz(os.path.join(
            REPO, "demo", "outputs", name + ".xyz"))[:, :3]).cuda()
        gt = torch.from_numpy(load_cloud(name.split("_X")[0] + ".xyz")).cuda()
        demo[name] = (pred, gt, [float(x) for x in metrics.cd_hd(pred, gt)])
    demo_counts = kernels.launch_counts()
    for name, (pred, gt, got) in demo.items():
        plain = [float(x) for x in metrics.cd_hd(pred, gt, impl="torch")]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, plain))
        log(f"demo {name} ({pred.shape[0]} -> {gt.shape[0]}): CD {got[0]!r}, "
            f"hausdorff {got[1]!r}; kernel vs plain argmin rel {rel:.2e} "
            f"(bound {EVAL_CD_REL}); demo/outputs/evaluation.csv (TPU, "
            f"informative): CD {tracked[name + '.xyz']['CD']}, hausdorff "
            f"{tracked[name + '.xyz']['hausdorff']}")
        require(rel <= EVAL_CD_REL, f"demo {name}: kernel vs plain {rel}")
    require(demo_counts["knn"] == len(demo) and sum(demo_counts.values())
            == len(demo), f"demo cd_hd launches {demo_counts}: one knn a "
            f"pair expected")
    log(f"evaluation phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    return add_counts(counts, demo_counts)



# ------------------------------------------------------ phase 4: training


def expected_forward_counts(cfg) -> dict:
    """Kernel launches of one training forward of the generator, from the
    configuration and the JAX package's gates: a feature-space kNN in each
    dense block and the refiner's xyz kNN, each the fused ``knn_group``
    with ``fused_grouping`` inside its gate (backbone 64 ≤ n ≤ 2048,
    refiner n ≤ 2048), else with ``fast_knn`` the packed selection inside
    its gate (64 ≤ n ≤ 4096, c ≤ 128, k ≤ 128), else the exact one; the NL
    cell's attention (maps of at least 512²); with ``gather_impl='pallas'``
    (and no turbo gather) each block's and the refiner's gather inside
    ``gather_fits``.  At bf16 compute the attention is the kernel's bf16
    entry, and the gather kernel takes the f32 tables alone (the refiner's
    ``[xyz | feature]`` one; the dense blocks' features are bf16).
    Returns (counts, the backbone's and the refiner's gathers that the
    backward sums with the scatter kernel)."""
    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.models.generator import DisPUGenerator
    from dispu_tpu_torch.ops.grouping import _rows_fit, gather_fits

    g, n_out = cfg.generator, cfg.generator.num_out_points
    n_in = g.num_points
    nl = g.refine and g.use_nonlocal and n_out * n_out >= 512 * 512
    fused_bb = g.fused_grouping and 64 <= n_in <= 2048 and g.knn + 1 <= 128
    fused_ref = g.fused_grouping and g.refine and n_out <= 2048
    model = DisPUGenerator(g, impl="torch")
    widths = [model.feature_extraction_coarse.layer1.l0.dense.in_features
              // 2]
    widths += [getattr(model.feature_extraction_coarse, f"layer{i}_prep")
               .features for i in range(2, g.dense_block + 1)]
    c_ref = (model.PointShuffle.skip.dense.in_features - 6 if g.refine
             else 0)
    packed_bb = [g.fast_knn and not fused_bb and 64 <= n_in <= 4096
                 and w <= 128 and g.knn + 1 <= 128 for w in widths]
    packed_ref = (g.fast_knn and g.refine and not fused_ref
                  and 64 <= n_out <= 4096 and g.refine_nsample <= 128)
    gathers = scatters = 0
    bf16 = cfg.train.compute_dtype != "float32"
    if g.fast_gather_backbone and not fused_bb:  # the bf16 one-hot's sums
        scatters += sum(_rows_fit(n_in, w) for w in widths)
    if g.fast_gather and g.refine and not fused_ref:
        scatters += int(_rows_fit(n_out, c_ref))
    if g.gather_impl == "pallas" and not g.fused_grouping:
        dt = torch.bfloat16 if bf16 else torch.float32
        if not g.fast_gather_backbone:
            gathers += sum(gather_fits(torch.empty(0, n_in, w, dtype=dt))
                           for w in widths)
        if g.refine and not g.fast_gather:
            gathers += int(gather_fits(torch.empty(0, n_out, 3 + c_ref)))
    counts = dict(dict.fromkeys(kernels.LAUNCHES, 0),
                  knn=(len(widths) * (not fused_bb) - sum(packed_bb)
                       + int(g.refine and not fused_ref and not packed_ref)),
                  knn_packed=sum(packed_bb) + int(packed_ref),
                  knn_group=g.dense_block * fused_bb + int(fused_ref),
                  **{"attention_bf16" if bf16 else "attention": int(nl)},
                  gather_rows=gathers)
    # the backward: each gather's scatter, the fused kernel's (features,
    # and in the refiner the xyz), the bf16 one-hot gathers' sums
    return counts, (gathers + scatters + g.dense_block * fused_bb
                    + 2 * fused_ref)


def expected_train_counts(cfg) -> dict:
    """Kernel launches of one CD train step, from the configuration and
    the JAX package's gates: the generator's forward
    (``expected_forward_counts``; again with ``remat``, whose backward
    recomputes it), its backward's scatters, the chamfer argmin of both
    directions of the four Chamfer/Hausdorff terms (kNN at k = 1: 64 ≤
    points ≤ 4096) and one ball query for the repulsion loss."""
    fwd, scatters = expected_forward_counts(cfg)
    n_out = cfg.generator.num_out_points
    counts = add_counts({}, fwd, 2 if cfg.train.remat else 1)
    counts["knn"] += 8 if 64 <= n_out <= 4096 else 0
    counts["query_ball"] += int(cfg.loss.use_repulsion)
    counts["scatter_rows"] += scatters
    return counts


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


def compare_steps(label, m_k, g_k, m_p, g_p, extra="", metric_floor=0.0,
                  metric_max=None, grad_max=None):
    """One step through the kernels against one through the plain
    versions: metrics within ``metric_max`` (``TRAIN_METRIC_REL``; of
    the larger of the metric and ``metric_floor`` of the largest one),
    gradients within ``grad_max`` (``TRAIN_GRAD_REL``) of each leaf's
    largest, and every parameter with a gradient on the plain path has one
    through the kernels."""
    metric_max = TRAIN_METRIC_REL if metric_max is None else metric_max
    grad_max = TRAIN_GRAD_REL if grad_max is None else grad_max
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
        f"metrics max rel {metric_rel:.3e} (bound {metric_max}), "
        f"gradients max |d| / leaf max {grad_rel:.3e} (bound "
        f"{grad_max}); {len(g_p)} parameters, gradient zero through "
        f"the kernels only at {dead}{extra}")
    require(not dead, f"{label}: no gradient through the kernels at {dead}")
    require(metric_rel <= metric_max,
            f"{label}: metrics differ {metric_rel}")
    require(grad_rel <= grad_max,
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
            if "non_local.conv_kv.dense.weight" in n
            or "non_local.conv_query.dense.weight" in n)))

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
    # (f) refine_local_impl='megafused' trains on the composed refiner, as
    # in the JAX package: one step launches what the default step does,
    # none of the refine kernels, and its metrics are the default step's
    # bits from the same state and seed
    mcfg = dataclasses.replace(cfg, generator=dataclasses.replace(
        cfg.generator, refine_local_impl="megafused"))
    kernels.reset_launch_counts()
    _, _, m_mega = run("auto", 1, c=mcfg)
    counts = kernels.launch_counts()
    log(f"training, refine_local_impl=megafused: launches of one step "
        f"{counts} (expected the default step's {per_step})")
    require(counts == per_step, f"megafused train launch counts {counts}")
    total_counts = add_counts(total_counts, counts)
    kernels.reset_launch_counts()
    _, _, m_def = run("auto", 1)
    total_counts = add_counts(total_counts, kernels.launch_counts())
    same = all(float(m_mega[k]) == float(m_def[k]) for k in m_def)
    log(f"training, refine_local_impl=megafused: metrics bit-equal to the "
        f"default step's: {same}")
    require(same, "megafused train step differs from the default step")
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


# a turbo train step (every turbo flag; the same without fused_grouping)
# through the kernels vs through the plain versions on the card, as
# ``compare_steps`` reads them.  Set before the first run of the phase:
# the packed selection's keys are truncated distances, so where the
# kernel's FMA distances and the plain version's cuBLAS ones fall on two
# sides of a truncation step (2^-15 relative at n 256, 2^-13 at 1024)
# the two keep other neighbours, far more often than the exact
# selection's near-ties; a bf16 gather rounds a value one ulp (2^-8)
# apart where the f32 inputs differ in the last bit.  Predicted readings:
# metrics ≤ 1e-4, gradients ≤ 1e-2.
TURBO_TRAIN_METRIC_REL = 1e-3
TURBO_TRAIN_GRAD_REL = 5e-2
TURBO_FLAGS = dict(fast_knn=True, fast_gather=True, fast_gather_backbone=True,
                   fused_grouping=True, dense_impl="split")


def turbo_train_cases():
    """The train step's turbo kernel shapes at batch 28: ``knn_group`` in
    turbo mode with every turbo flag (the backbone's edge gathers at c 24
    and 48, the refiner's grouping with xyz and 128 features) and the
    packed selection without ``fused_grouping`` (the backbone's at k 17
    with the duplicate bias, the refiner's at k 16), each with its
    launches a step."""
    from dispu_tpu_torch.kernels.measure import KnnCase, KnnGroupCase

    group = [KnnGroupCase("turbo bb c24", 28, 256, 24, 0, 16, False, False,
                          True, 0, 1),
             KnnGroupCase("turbo bb c48", 28, 256, 48, 0, 16, False, False,
                          True, 0, 3),
             KnnGroupCase("turbo refiner", 28, 1024, 3, 128, 16, False, True,
                          False, 0, 1)]
    packed = [KnnCase("packed bb c24", 28, 256, 256, 24, 17, True, "self",
                      0, 1),
              KnnCase("packed bb c48", 28, 256, 256, 48, 17, True, "self",
                      0, 3),
              KnnCase("packed refiner", 28, 1024, 1024, 3, 16, False, "self",
                      0, 1)]
    return group, packed


def check_knn_packed_train(dev, cases):
    """The packed selection at the train step's shapes (``cases``, each
    point its own query, duplicates biased by 1e30 where ``dup``): its
    distances the kNN kernel's exact ones truncated, its indices moving
    only at truncation ties, against the plain version swaps only where
    the plain distances agree to one truncation step; kernel, plain and
    ``cdist``+``topk`` ms and the bound of each shape.  Returns the
    aggregate of a step (each case by ``per_step``)."""
    import torch

    from dispu_tpu_torch.kernels.knn import (knn_packed_cuda,
                                             knn_packed_torch,
                                             packed_lane_bits)
    from dispu_tpu_torch.kernels.measure import knn_inputs
    from dispu_tpu_torch.ops.knn import mask_duplicate_rows

    gen = torch.Generator(device="cpu").manual_seed(8)
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               t_bytes=0.0, t_ops=0.0, max_abs_err=0.0)
    for case, (pts, _) in zip(cases, knn_inputs(gen, cases)):
        x = pts.to(dev)
        k, lb = case.k, packed_lane_bits(case.n)
        bias = (mask_duplicate_rows(x).float() * 1e30) if case.dup else None
        _, _, _, swaps, max_abs = packed_contract(
            f"knn_packed {case.label}", k, x, bias)
        ms = timed_ms(lambda: knn_packed_cuda(k, x, x, bias), reps=20)
        plain_ms = timed_ms(lambda: knn_packed_torch(k, x, x, bias), reps=5)

        def library():
            dd = torch.cdist(x, x) ** 2
            if bias is not None:
                dd = dd + bias[:, None, :]
            return torch.topk(dd, k, dim=-1, largest=False)

        library_ms = timed_ms(library, reps=5)
        b, n, c = x.shape
        nbytes = 4 * (2 * b * n * c + (b * n if bias is not None else 0)) \
            + 8 * b * n * k
        ops = b * n * n * (2 * c + 4)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"knn_packed {case.label:14s} (b={b} n=m={n} c={c} k={k}, {lb} "
            f"lane bits{', dup bias' if bias is not None else ''}): "
            f"distances = the kNN kernel's truncated; vs plain: swaps "
            f"{swaps}, max|d|err {max_abs:.3e}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, cdist+topk {library_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by}); {case.per_step} a turbo step")
        w = case.per_step
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("bound_ms", bms),
                       ("t_bytes", nbytes / HBM_BYTES_PER_S),
                       ("t_ops", ops / F32_FLOPS)):
            agg[key] += w * v
        agg["max_abs_err"] = max(agg["max_abs_err"], max_abs)
    return agg


def train_turbo(card: str):
    """Training with the turbo flags at full GeneratorConfig() width,
    batch 28, on synthetic patches, from the port's seeded init: a CD step
    with every turbo flag (``knn_group`` in turbo mode and its backward
    rule), the same without ``fused_grouping`` (the packed selection, the
    bf16 one-hot gathers and their sums on the scatter kernel), and a GAN
    step (``dispu.py --use_gan true``'s defaults) with every turbo flag:
    each with exact launch counts, against the plain versions
    (``TURBO_TRAIN_METRIC_REL``, ``TURBO_TRAIN_GRAD_REL``), two bit-equal
    3-step runs, and ms per warm step beside the exact step's, in turns.
    The turbo kernels at the step's shapes first (kernel, plain, library
    ms and bound a shape, and a step's sum)."""
    import dataclasses
    import statistics

    import torch

    from dispu_tpu_torch import cli, kernels
    from dispu_tpu_torch.config import ExperimentConfig
    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    group_cases, packed_cases = turbo_train_cases()
    g_agg = check_knn_group(dev, group_cases, per="per_step")
    p_agg = check_knn_packed_train(dev, packed_cases)
    for name, a in (("knn_group turbo", g_agg), ("knn_packed", p_agg)):
        log(f"{name}, a turbo train step's launches: kernel {a['ms']:.4f} "
            f"ms, plain {a['plain_ms']:.4f} ms, library "
            f"{a['library_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms "
            f"({'bytes' if a['t_bytes'] >= a['t_ops'] else 'operations'})")

    def with_flags(c, **flags):
        return dataclasses.replace(c, generator=dataclasses.replace(
            c.generator, **flags))

    cd = ExperimentConfig()
    gan = cli.build_config(cli.parse_args(["--phase", "train", "--use_gan",
                                           "true"]))
    packed_flags = dict(TURBO_FLAGS, fused_grouping=False)
    cases = [("CD", "every turbo flag", with_flags(cd, **TURBO_FLAGS)),
             ("CD", "turbo without fused_grouping",
              with_flags(cd, **packed_flags)),
             ("GAN", "every turbo flag", with_flags(gan, **TURBO_FLAGS))]
    bs = cd.train.batch_size
    dataset = PatchDataset(h5_path=os.path.join(REPO, "absent.h5"),
                           synthetic_patches_count=bs, seed=0)
    gt = torch.from_numpy(dataset.gt[:bs]).cuda()
    radius = torch.from_numpy(dataset.radius[:bs]).cuda()
    kinds = {
        "CD": (lambda c, impl: create_generator_state(
            c.generator, seed=0, impl=impl, device="cuda"), make_train_step,
            expected_train_counts, lambda st: {"": st.model}, 0.0),
        "GAN": (lambda c, impl: create_gan_state(c, seed=0, impl=impl,
                                                 device="cuda"),
                make_gan_train_step, expected_gan_counts,
                lambda st: {"generator.": st.gen.model,
                            "critic.": st.disc}, GAN_METRIC_FLOOR),
    }

    def run(kind, c, impl, steps, seed=0, times=None):
        st, step = kinds[kind][0](c, impl), kinds[kind][1](c, impl=impl)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, m = step(st, gt, radius, gen)
            float(m["total"])  # a host fetch: synchronized
            if times is not None:
                times.append((time.perf_counter() - t) * 1e3)
        return st, m

    def grads(kind, st):
        return {f"{prefix}{n}": g for prefix, mod in kinds[kind][3](st)
                .items() for n, g in _grads(mod).items()}

    total = {}
    for kind, name, c in cases:
        expect, floor = kinds[kind][2], kinds[kind][4]
        kernels.reset_launch_counts()
        st_k, m_k = run(kind, c, "auto", 1)
        counts = kernels.launch_counts()
        want = expect(c)
        log(f"turbo {kind} training, {name}: launches of one step {counts} "
            f"(expected {want})")
        require(counts == want and counts["knn_group"]
                + counts["knn_packed"] > 0,
                f"turbo {kind} {name}: launch counts {counts}")
        total = add_counts(total, counts)
        st_p, m_p = run(kind, c, "torch", 1)
        compare_steps(f"turbo {kind} training, {name}", m_k, grads(kind, st_k),
                      m_p, grads(kind, st_p), metric_floor=floor,
                      metric_max=TURBO_TRAIN_METRIC_REL,
                      grad_max=TURBO_TRAIN_GRAD_REL)
        kernels.reset_launch_counts()
        require_repeatable(f"turbo {kind} training, {name}", lambda: tuple(
            kinds[kind][3](run(kind, c, "auto", 3, seed=3)[0]).values()))
        total = add_counts(total, kernels.launch_counts())

    # ms per warm step beside the exact step's, in turns
    kernels.reset_launch_counts()
    for kind, pair in (("CD", {"exact": cd, "turbo": cases[0][2],
                               "turbo, no fused": cases[1][2]}),
                       ("GAN", {"exact": gan, "turbo": cases[2][2]})):
        laps = {k: [] for k in pair}
        for _ in range(2):
            for label, c in pair.items():
                times = []
                run(kind, c, "auto", 6, times=times)
                laps[label] += times[1:]
        med = {k: statistics.median(v) for k, v in laps.items()}
        log(f"turbo {kind} training: ms per warm step at batch {bs}, two "
            f"turns of 5 each: " + "; ".join(
                f"{k} median {med[k]:.3f} (min {min(laps[k]):.3f}), / exact "
                f"{med[k] / med['exact']:.3f}" for k in pair)
            + f" on {card}")
    total = add_counts(total, kernels.launch_counts())
    log(f"train_turbo: {time.perf_counter() - t_phase:.1f} s on {card}")
    return total


def train_remat(card: str):
    """``remat`` in training at full width: a CD step with
    ``gather_impl='pallas'`` (so that the gather pair runs under the
    recompute), the same with ``use_bn=True`` and a GAN step with
    ``dispu.py --use_gan true``'s defaults and ``gather_impl='pallas'``,
    each with ``remat`` against the same step without it from one state:
    exact launch counts (the generator's forward kernels twice), metrics,
    gradients and batch norm's running statistics bit-equal (or the gap
    printed and the phase failed).  Then peak device memory
    (``max_memory_allocated``) of one warm CD step with and without
    ``remat`` at batch 28 and 112, with its ms."""
    import dataclasses
    import statistics

    import torch

    from dispu_tpu_torch import cli, kernels
    from dispu_tpu_torch.config import ExperimentConfig
    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import generator_forward, make_train_step

    t_phase = time.perf_counter()

    def remat(c, on=True, **gen):
        return dataclasses.replace(
            c, generator=dataclasses.replace(c.generator, **gen),
            train=dataclasses.replace(c.train, remat=on))

    cd = remat(ExperimentConfig(), False, gather_impl="pallas")
    gan = remat(cli.build_config(cli.parse_args(
        ["--phase", "train", "--use_gan", "true"])), False,
        gather_impl="pallas")
    bn = remat(cd, False, use_bn=True)
    dataset = PatchDataset(h5_path=os.path.join(REPO, "absent.h5"),
                           synthetic_patches_count=112, seed=0)

    def batch(bs):
        return (torch.from_numpy(dataset.gt[:bs]).cuda(),
                torch.from_numpy(dataset.radius[:bs]).cuda())

    def run(c, steps=1, bs=28, times=None):
        gt, radius = batch(bs)
        if c.use_gan:
            st = create_gan_state(c, seed=0, device="cuda")
            step = make_gan_train_step(c)
        else:
            st = create_generator_state(c.generator, seed=0, device="cuda")
            step = make_train_step(c)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, m = step(st, gt, radius, gen)
            float(m["total"])
            if times is not None:
                times.append((time.perf_counter() - t) * 1e3)
        return st, m

    def tensors(st):
        mods = (st.gen.model, st.disc) if hasattr(st, "disc") else (st.model,)
        out = {}
        for i, mod in enumerate(mods):
            out.update({f"{i}.{n}": t for n, t in mod.state_dict().items()})
            out.update({f"{i}.{n}.grad": g for n, g in _grads(mod).items()})
        return out

    total = {}
    for label, c in (("CD", cd), ("CD use_bn", bn), ("GAN", gan)):
        kernels.reset_launch_counts()
        st_r, m_r = run(remat(c))
        counts = kernels.launch_counts()
        want = (expected_gan_counts if c.use_gan
                else expected_train_counts)(remat(c))
        require(counts == want, f"remat {label}: launch counts {counts} "
                f"(expected {want})")
        total = add_counts(total, counts)
        kernels.reset_launch_counts()
        st_p, m_p = run(c)
        total = add_counts(total, kernels.launch_counts())
        a, b = tensors(st_r), tensors(st_p)
        gaps = {n: float((a[n].double() - b[n].double()).abs().max())
                for n in a if not torch.equal(a[n], b[n])}
        metric_gaps = {k: float(m_r[k]) - float(m_p[k]) for k in m_p
                       if float(m_r[k]) != float(m_p[k])}
        log(f"remat {label} (gather_impl=pallas): launches of one step "
            f"{counts}; against the step without remat: tensors that differ "
            f"{len(gaps)} of {len(a)} (parameters, gradients, batch-norm "
            f"statistics) {sorted(gaps.items(), key=lambda kv: -kv[1])[:3]}"
            f", metrics that differ {metric_gaps}")
        require(not gaps and not metric_gaps,
                f"remat {label}: differs from the step without remat")
    del st_r, st_p, a, b

    for bs in (28, 112):
        peak, ms = {}, {}
        for on in (False, True):
            c = remat(cd, on, gather_impl="onehot_hp")
            torch.cuda.reset_peak_memory_stats()
            times = []
            run(c, steps=6, bs=bs, times=times)
            peak[on] = torch.cuda.max_memory_allocated() / 2 ** 30
            ms[on] = statistics.median(times[1:])
        log(f"remat: CD step at batch {bs} (defaults): peak memory "
            f"{peak[False]:.3f} GiB without, {peak[True]:.3f} GiB with "
            f"remat ({peak[True] / peak[False]:.3f}); ms per warm step "
            f"{ms[False]:.3f} without, {ms[True]:.3f} with on {card}")
    # where the peak lies: what the generator's forward holds for the
    # backward, and the peak of its backward, at batch 112
    gt, _ = batch(112)
    model = create_generator_state(cd.generator, seed=0,
                                   device="cuda").model.train()
    inputs = gt[:, :cd.generator.num_points].contiguous()
    for on in (False, True):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        coarse, fine = generator_forward(model, inputs, on)
        held = torch.cuda.memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        (coarse.sum() + fine.sum()).backward()
        model.zero_grad(set_to_none=True)
        log(f"remat {on}: the generator's forward at batch 112 holds "
            f"{held / 2 ** 30:.3f} GiB for its backward, whose peak is "
            f"{(torch.cuda.max_memory_allocated() - before) / 2 ** 30:.3f} "
            f"GiB above the forward's start")
        del coarse, fine
    log(f"train_remat: {time.perf_counter() - t_phase:.1f} s on {card}")
    return total


# bf16 compute through the kernels vs through the plain versions on the
# card: symmetric Chamfer over the plain output's own mean squared
# nearest-neighbour spacing, by setting.  The two paths round the
# attention's f32 output and the dense layers' products to bf16 at the
# same points, but the kernels sum in other orders, so a value near a
# bf16 rounding edge can land one ulp apart and move the later layers
# (at 16x, pass 2's inputs too).  Each limit lies between the readings
# of ``bf16_limit_readings`` on an H100 at 700 W (generator seeds 0-5,
# both demo clouds): kernels vs plain at most 1.4e-2 (4x), 3.9e-2
# (turbo 4x), 0.14 (16x); a control, the plain path with the attention's
# probabilities left f32, at least 6.9e-2, 6.9e-2 and 0.28 from it.
BF16_CHAMFER_REL = {"4x": 3e-2, "turbo 4x": 5e-2, "16x": 0.2}
# one bf16 train step through the kernels vs through the plain versions:
# metrics (relative) and gradients (max |d| over the leaf's max |g|,
# floored at 1e-3 of the largest leaf's), as ``compare_steps`` reads them;
# a gradient is a bf16 product, so a sum that lands on another side of a
# rounding edge moves a leaf by one bf16 ulp of it (2^-8).  Readings on an
# H100 at 700 W: metrics 2.0e-5 (CD) and 6.4e-5 (GAN), gradients 6.9e-3.
BF16_TRAIN_METRIC_REL = 1e-3
BF16_TRAIN_GRAD_REL = 5e-2


def serve_bf16(card: str):
    """bf16 compute (``InferenceConfig(compute_dtype='bfloat16')``) at full
    width from the port's seeded init: two 4x and two 16x requests on each
    demo cloud, exact and turbo (``cli.build_config`` of ``--turbo true``
    at bf16), and two ``upsample_many`` calls of both clouds at each
    ratio, each path with exact launch counts (the attention kernel's
    bf16 entry, no gather or refiner kernel: the JAX package's gates at
    bf16), f32 outputs of the right shape, finite, bit-equal repeats;
    each output against the same path through the plain versions on the
    card (``BF16_CHAMFER_REL``) and beside the f32 path's.  Then an
    exported bf16 entry served in this process, bit-equal to live with
    live's launches, and ms per request at bf16 beside f32, in turns."""
    import dataclasses
    import shutil
    import statistics

    import numpy as np
    import torch

    from dispu_tpu_torch import InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.serving import ServedUpsampler, export_upsampler

    t_phase = time.perf_counter()
    bf = "bfloat16"
    clouds = {name: load_cloud(name)
              for name in ("Icosahedron.xyz", "fandisk.xyz")}
    pcs = np.stack(list(clouds.values()))
    turbo = turbo_config()
    settings = {}
    for ratio in (4, 16):
        settings[f"{ratio}x"] = (None, InferenceConfig(final_ratio=ratio,
                                                       compute_dtype=bf))
    settings["turbo 4x"] = (turbo.generator, dataclasses.replace(
        turbo.inference, final_ratio=4, compute_dtype=bf))
    total, ups = {}, {}
    for label, (gen_cfg, inf) in settings.items():
        kw = {} if gen_cfg is None else dict(gen_cfg=gen_cfg)
        up = PatchUpsampler(inf_cfg=inf, seed=0, **kw)
        ref = PatchUpsampler(inf_cfg=inf, seed=0, impl="torch", **kw)
        f32 = PatchUpsampler(inf_cfg=dataclasses.replace(
            inf, compute_dtype="float32"), seed=0, **kw)
        ups[label] = up
        ratio = inf.final_ratio
        calls = [(name, pc[None], 1) for name, pc in clouds.items()]
        calls.append(("upsample_many", pcs, len(pcs)))
        for name, batch, b in calls:
            n = batch.shape[1]
            expected = add_counts({}, expected_counts(up, n, b), 2)
            kernels.reset_launch_counts()
            outs = [up.upsample_many(batch) for _ in range(2)]
            counts = kernels.launch_counts()
            require(counts == expected,
                    f"bf16 {label} {name}: launches {counts} != {expected}")
            require(counts["attention_bf16"] > 0 and counts["attention"] == 0
                    and counts["gather_rows"] == counts["refine_local"]
                    == counts["refine_block"] == 0,
                    f"bf16 {label} {name}: the JAX gates' routes {counts}")
            total = add_counts(total, counts)
            out = outs[0]
            require(out.dtype == np.float32 and out.shape == (b, n * ratio, 3)
                    and np.isfinite(out).all(),
                    f"bf16 {label} {name}: {out.dtype} {out.shape}")
            require(np.array_equal(outs[0], outs[1]),
                    f"bf16 {label} {name}: repeated call differs")
            plain = ref.upsample_many(batch)
            full = f32.upsample_many(batch)
            rel, rel_f32 = [], []
            for v in range(b):
                spacing = own_spacing2(plain[v])
                rel.append(chamfer(out[v], plain[v]) / spacing)
                rel_f32.append(chamfer(out[v], full[v]) / spacing)
            log(f"bf16 {label} {name}: launches {counts}; kernels vs plain "
                f"on the card: Chamfer / own spacing² "
                f"{['%.3e' % r for r in rel]} (bound "
                f"{BF16_CHAMFER_REL[label]}); bf16 vs f32 path "
                f"{['%.3e' % r for r in rel_f32]}")
            require(max(rel) <= BF16_CHAMFER_REL[label],
                    f"bf16 {label} {name}: Chamfer rel {rel}")

    # an exported bf16 entry, served here: bit-equal to live
    work = os.path.join(REPO, "chiprun_out", "serve_bf16")
    shutil.rmtree(work, ignore_errors=True)
    up = ups["4x"]
    pc = clouds["Icosahedron.xyz"]
    n = pc.shape[0]
    manifest = export_upsampler(up.model.state_dict(), [n], work,
                                inf_cfg=up.inf_cfg)
    served = ServedUpsampler(work)
    kernels.reset_launch_counts()
    live = up.upsample(pc)
    live_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    got = served.upsample(pc)
    counts = kernels.launch_counts()
    require(manifest["inference_config"]["compute_dtype"] == bf
            and np.array_equal(got, live) and counts == live_counts,
            f"bf16 export: served differs from live (launches {counts}, "
            f"live {live_counts})")
    total = add_counts(add_counts(total, counts), live_counts)
    log(f"bf16 export: entry ops {manifest['entries'][0]['kernels']}, "
        f"served bit-equal to live, launches {counts} (= live)")

    # ms per request, bf16 beside f32, in turns
    kernels.reset_launch_counts()
    for label in ("4x", "16x"):
        inf = ups[label].inf_cfg
        pair = {"f32": PatchUpsampler(inf_cfg=dataclasses.replace(
            inf, compute_dtype="float32"), seed=0), "bf16": ups[label]}
        reps = 3 if inf.final_ratio == 16 else 5
        laps = {k: [] for k in pair}
        for rep in range(reps + 1):  # the first round warms both
            for kind, u in pair.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                u.upsample(pc)  # returns on the host: synchronized
                if rep:
                    laps[kind].append((time.perf_counter() - t0) * 1e3)
        med = {k: statistics.median(v) for k, v in laps.items()}
        each = {k: ", ".join("%.2f" % t for t in v) for k, v in laps.items()}
        log(f"bf16 {label}: ms per 2048-point request, in turns, median of "
            f"{reps}: f32 {med['f32']:.2f} ({each['f32']}), bf16 "
            f"{med['bf16']:.2f} ({each['bf16']}), bf16 / f32 "
            f"{med['bf16'] / med['f32']:.3f} on {card}")
    total = add_counts(total, kernels.launch_counts())
    log(f"serve_bf16: {time.perf_counter() - t_phase:.1f} s on {card}")
    return total


def bf16_limit_readings(card: str, seeds=tuple(range(6))):
    """The readings ``BF16_CHAMFER_REL`` is set from (not part of the smoke
    run): for each generator seed, each of ``serve_bf16``'s settings and
    each demo cloud, Chamfer / own spacing² of the bf16 request through
    the kernels against the plain bf16 path, and of a control against the
    plain path: the plain path with one rounding point taken out (the
    attention's probabilities kept in f32 for the second product, where
    the kernel and its plain version round them to bf16; the dense
    layers' biases are zero at the seeded init, so their rounding points
    cannot serve).  A limit between the two separates the kernels' sum
    orders from a path that rounds at another point.  Run alone:
    ``python3 -c "import sys; sys.path.insert(0, '.'); import chip_smoke
    as cs; from dispu_tpu_torch.inference import pin_f32; pin_f32();
    cs.bf16_limit_readings('card')"``."""
    import dataclasses

    import torch

    from dispu_tpu_torch import InferenceConfig
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.kernels import attention as attention_module

    attention_torch = attention_module.attention_torch

    def p_unrounded(q, k, v, scale, bf16_operands=False):
        if not bf16_operands:
            return attention_torch(q, k, v, scale)
        bf = attention_module._bf16
        s = torch.einsum("bqc,bnc->bqn", bf(q), bf(k)) * scale
        p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        denom = torch.sum(p, dim=-1, keepdim=True)
        return torch.einsum("bqn,bnc->bqc", p, bf(v)) / denom

    t_phase = time.perf_counter()
    bf = "bfloat16"
    clouds = {name: load_cloud(name)
              for name in ("Icosahedron.xyz", "fandisk.xyz")}
    turbo = turbo_config()
    settings = {f"{r}x": (None, InferenceConfig(final_ratio=r,
                                                 compute_dtype=bf))
                for r in (4, 16)}
    settings["turbo 4x"] = (turbo.generator, dataclasses.replace(
        turbo.inference, final_ratio=4, compute_dtype=bf))
    worst = {}
    for seed in seeds:
        for label, (gen_cfg, inf) in settings.items():
            kw = dict(seed=seed, inf_cfg=inf)
            if gen_cfg is not None:
                kw["gen_cfg"] = gen_cfg
            up = PatchUpsampler(**kw)
            ref = PatchUpsampler(impl="torch", **kw)
            for name, pc in clouds.items():
                out, plain = up.upsample(pc), ref.upsample(pc)
                attention_module.attention_torch = p_unrounded
                try:
                    control = ref.upsample(pc)
                finally:
                    attention_module.attention_torch = attention_torch
                spacing = own_spacing2(plain)
                rel = chamfer(out, plain) / spacing
                rel_control = chamfer(control, plain) / spacing
                w = worst.setdefault(label, [0.0, float("inf")])
                w[0], w[1] = max(w[0], rel), min(w[1], rel_control)
                log(f"bf16 limits: seed {seed} {label} {name}: kernels vs "
                    f"plain {rel:.4e}, control vs plain {rel_control:.4e}")
    for label, (kernels_max, control_min) in worst.items():
        log(f"bf16 limits: {label}: kernels vs plain at most "
            f"{kernels_max:.4e}, control vs plain at least {control_min:.4e}"
            f" over seeds {list(seeds)}")
    log(f"bf16_limit_readings: {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")
    return worst


def train_bf16(card: str):
    """bf16 compute in training at full width, batch 28, on synthetic
    patches, from the port's seeded init: CD steps with the TrainConfig
    defaults and GAN steps with ``dispu.py --use_gan true``'s, each at
    ``compute_dtype='bfloat16'``: 10 steps on one batch (the loss falls,
    exact launch counts: the attention kernel's bf16 entry), every
    parameter, gradient and Adam moment an f32 tensor, one step through
    the kernels against one through the plain versions
    (``BF16_TRAIN_METRIC_REL``, ``BF16_TRAIN_GRAD_REL``), two bit-equal
    3-step runs, and ms per step at bf16 beside f32, in turns."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from dispu_tpu_torch import cli, kernels
    from dispu_tpu_torch.config import ExperimentConfig, TrainConfig
    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    bf = "bfloat16"
    cd = ExperimentConfig(train=dataclasses.replace(TrainConfig(),
                                                    compute_dtype=bf))
    gan = cli.build_config(cli.parse_args(
        ["--phase", "train", "--use_gan", "true", "--compute_dtype", bf]))
    bs = cd.train.batch_size
    dataset = PatchDataset(h5_path=os.path.join(REPO, "absent.h5"),
                           synthetic_patches_count=bs, seed=0)
    gt = torch.from_numpy(dataset.gt[:bs]).cuda()
    radius = torch.from_numpy(dataset.radius[:bs]).cuda()
    kinds = {
        "CD": (lambda c, impl: create_generator_state(
            c.generator, seed=0, impl=impl, device="cuda"), make_train_step,
            expected_train_counts,
            lambda st: {"": (st.model, st.mu, st.nu)}, 0.0),
        "GAN": (lambda c, impl: create_gan_state(c, seed=0, impl=impl,
                                                 device="cuda"),
                make_gan_train_step, expected_gan_counts,
                lambda st: {"generator.": (st.gen.model, st.gen.mu,
                                           st.gen.nu),
                            "critic.": (st.disc, st.d_mu, st.d_nu)},
                GAN_METRIC_FLOOR),
    }

    def run(kind, c, impl, steps, seed=0, times=None):
        make_state, make_step = kinds[kind][:2]
        st, step = make_state(c, impl), make_step(c, impl=impl)
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

    total = {}
    for kind, c in (("CD", cd), ("GAN", gan)):
        _, _, expect, parts, floor = kinds[kind]
        kernels.reset_launch_counts()
        st, totals, m = run(kind, c, "auto", 10)
        counts = kernels.launch_counts()
        require(counts == add_counts({}, expect(c), 10)
                and counts["attention_bf16"] == 10,
                f"bf16 {kind}: launches over 10 steps {counts}")
        total = add_counts(total, counts)
        tensors = {f"{prefix}{n}": t
                   for prefix, (mod, mu, nu) in parts(st).items()
                   for group in (dict(mod.named_parameters()),
                                 {f"{k}.grad": p.grad for k, p in
                                  mod.named_parameters()},
                                 {f"{k}.mu": v for k, v in mu.items()},
                                 {f"{k}.nu": v for k, v in nu.items()})
                   for n, t in group.items()}
        not_f32 = sorted(n for n, t in tensors.items()
                         if t is None or t.dtype != torch.float32)
        metrics_f32 = all(m[k].dtype == torch.float32 for k in m
                          if torch.is_tensor(m[k]))
        log(f"bf16 {kind} training: 10 steps on one batch: total "
            f"{totals[0]:.4f} -> {totals[-1]:.4f}; launches {counts}; "
            f"{len(tensors)} parameters, gradients and moments, not f32 "
            f"(or missing): {not_f32}; metrics f32: {metrics_f32}")
        require(np.isfinite(totals).all() and totals[-1] < totals[0],
                f"bf16 {kind}: loss did not fall: {totals}")
        require(not not_f32 and metrics_f32,
                f"bf16 {kind}: tensors not f32 {not_f32}")

        def grads(st):
            return {f"{prefix}{n}": g for prefix, (mod, _, _) in
                    parts(st).items() for n, g in _grads(mod).items()}

        st_k, _, m_k = run(kind, c, "cuda", 1)
        st_p, _, m_p = run(kind, c, "torch", 1)
        compare_steps(f"bf16 {kind} training", m_k, grads(st_k), m_p,
                      grads(st_p), metric_floor=floor,
                      metric_max=BF16_TRAIN_METRIC_REL,
                      grad_max=BF16_TRAIN_GRAD_REL)
        kernels.reset_launch_counts()
        require_repeatable(f"bf16 {kind} training", lambda: tuple(
            mod for mod, _, _ in parts(run(kind, c, "auto", 3,
                                           seed=3)[0]).values()))
        total = add_counts(total, kernels.launch_counts())

    # ms per warm step, bf16 beside f32, in turns
    kernels.reset_launch_counts()
    for kind, c in (("CD", cd), ("GAN", gan)):
        pair = {"f32": dataclasses.replace(c, train=dataclasses.replace(
            c.train, compute_dtype="float32")), "bf16": c}
        laps = {k: [] for k in pair}
        for _ in range(2):
            for name, cc in pair.items():
                times = []
                run(kind, cc, "auto", 6, times=times)
                laps[name] += times[1:]
        med = {k: statistics.median(v) for k, v in laps.items()}
        log(f"bf16 {kind} training: ms per warm step at batch {bs}, two "
            f"turns of 5 each: f32 median {med['f32']:.3f} (min "
            f"{min(laps['f32']):.3f}), bf16 median {med['bf16']:.3f} (min "
            f"{min(laps['bf16']):.3f}), bf16 / f32 "
            f"{med['bf16'] / med['f32']:.3f} on {card}")
    total = add_counts(total, kernels.launch_counts())
    log(f"train_bf16: {time.perf_counter() - t_phase:.1f} s on {card}")
    return total


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

    kind = ("turbo" if up.gen_cfg.fused_grouping else
            f"exact, refine_local_impl={up.gen_cfg.refine_local_impl}")
    log(f"profile of one {up.inf_cfg.final_ratio}x request ({kind} "
        f"generator, {up.inf_cfg.merge_fps} merge):")
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


# ----------------------------------------------------- multi-device phase


#: sharded evaluation against the one-process ``cd_hd``, relative
MD_EVAL_REL = 1e-6
#: turns of (mesh-less, mesh) requests a serving setting
REQUEST_TURNS = 8


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def md_train_steps(card: str, mesh, label: str, cfg, make_state, make_step,
                   per_step: dict, checked: int, timed: int):
    """``checked`` steps of the mesh-less step and of the mesh step in
    turns from the same seeded state, batch and generator seed (batch 28
    of synthetic patches): metrics and every state tensor bit-equal, and
    each run with ``per_step`` launches a step; then ``timed`` more turns
    of each (plain, mesh, mesh, plain, ...), and the median ms of their
    warm steps."""
    import statistics

    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.data.dataset import synthetic_patches
    from dispu_tpu_torch.train.trainer import state_tensors

    bs = cfg.train.batch_size
    _, gt, radius = (torch.from_numpy(a).cuda() for a in synthetic_patches(
        bs, cfg.generator.num_out_points, seed=0))
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        runs[name] = dict(state=make_state(), step=make_step(m),
                          gen=torch.Generator(device="cuda").manual_seed(0),
                          metrics=[], ms=[], counts={})

    def turn(name):
        r = runs[name]
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        r["state"], m = r["step"](r["state"], gt, radius, r["gen"])
        host = {k: float(v) for k, v in m.items()}  # synchronized
        r["ms"].append((time.perf_counter() - t) * 1e3)
        r["metrics"].append(host)
        return kernels.launch_counts()

    for _ in range(checked):
        for name in runs:
            runs[name]["counts"] = add_counts(runs[name]["counts"],
                                              turn(name))
    want = add_counts({}, per_step, checked)
    same_metrics = runs["plain"]["metrics"] == runs["mesh"]["metrics"]
    a, b = (state_tensors(runs[n]["state"].state_dict())
            for n in ("plain", "mesh"))
    n_diff = sum(not torch.equal(x, y) for x, y in zip(a, b))
    log(f"multi_device {label}: {checked} steps of batch {bs}, world size "
        f"1 mesh against the mesh-less step: metrics bit-equal "
        f"{same_metrics}, state tensors that differ {n_diff} of "
        f"{len(a)}; launches mesh "
        f"{nonzero(runs['mesh']['counts'])} (expected {nonzero(want)})")
    require(same_metrics, f"multi_device {label}: metrics differ")
    require(n_diff == 0, f"multi_device {label}: {n_diff} tensors differ")
    for name in runs:
        require(runs[name]["counts"] == want,
                f"multi_device {label}: {name} launches "
                f"{runs[name]['counts']}")
    counts = runs["mesh"]["counts"]
    for i in range(timed):
        for name in (("plain", "mesh") if i % 2 == 0 else ("mesh", "plain")):
            c = turn(name)
            if name == "mesh":
                counts = add_counts(counts, c)
    med = {n: statistics.median(r["ms"][1:]) for n, r in runs.items()}
    log(f"multi_device {label}: ms per warm step in turns, median of "
        f"{checked + timed - 1}: mesh {med['mesh']:.3f}, plain "
        f"{med['plain']:.3f}, mesh / plain {med['mesh'] / med['plain']:.4f}"
        f"; on {card}")
    return counts


def md_serve(card: str, mesh):
    """4× and 16× exact and 4× turbo requests on demo/gt/Icosahedron.xyz
    through the mesh upsampler: bit-equal to the mesh-less one, with its
    launch counts, timed in turns; then ``upsample_many`` of both demo
    clouds at 4× and 16× through it, bit-equal to the mesh-less call."""
    import dataclasses
    import statistics

    import numpy as np

    from dispu_tpu_torch import InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler

    pc = load_cloud("Icosahedron.xyz")
    pcs = np.stack([pc, load_cloud("fandisk.xyz")])
    turbo = turbo_config()
    settings = {"4x": (None, InferenceConfig()),
                "16x": (None, InferenceConfig(final_ratio=16)),
                "4x turbo": (turbo.generator, dataclasses.replace(
                    turbo.inference, final_ratio=4))}
    total = {}
    for label, (gen_cfg, inf) in settings.items():
        kw = {} if gen_cfg is None else dict(gen_cfg=gen_cfg)
        ups = {name: PatchUpsampler(seed=0, inf_cfg=inf, mesh=m, **kw)
               for name, m in (("plain", None), ("mesh", mesh))}
        want = expected_counts(ups["plain"], pc.shape[0])
        outs, ms = {}, {name: [] for name in ups}
        for rep in range(REQUEST_TURNS):
            for name in (tuple(ups) if rep % 2 == 0
                         else tuple(reversed(ups))):
                up = ups[name]
                kernels.reset_launch_counts()
                t = time.perf_counter()
                out = up.upsample(pc)  # returns on the host: synchronized
                ms[name].append((time.perf_counter() - t) * 1e3)
                counts = kernels.launch_counts()
                require(counts == want, f"multi_device {label} {name}: "
                        f"launches {counts} != {want}")
                if name != "plain":
                    total = add_counts(total, counts)
                if rep == 0:
                    outs[name] = out
                require(np.array_equal(out, outs["plain"]),
                        f"multi_device {label} {name}: output differs from "
                        "the mesh-less request")
        med = {n: statistics.median(t[1:]) for n, t in ms.items()}
        log(f"multi_device {label} request, {pc.shape[0]} points: mesh "
            f"output bit-equal to the mesh-less one, launches "
            f"{nonzero(want)} each; ms in turns, median of "
            f"{REQUEST_TURNS - 1} warm: plain {med['plain']:.3f}"
            f", mesh {med['mesh']:.3f} "
            f"({med['mesh'] / med['plain']:.4f}); on {card}")
    for ratio in (4, 16):
        inf = InferenceConfig(final_ratio=ratio)
        plain = PatchUpsampler(seed=0, inf_cfg=inf)
        meshed = PatchUpsampler(seed=0, inf_cfg=inf, mesh=mesh)
        want = expected_counts(plain, pcs.shape[1], b=2)
        kernels.reset_launch_counts()
        got = meshed.upsample_many(pcs)
        counts = kernels.launch_counts()
        total = add_counts(total, counts)
        same = np.array_equal(got, plain.upsample_many(pcs))
        log(f"multi_device upsample_many of 2 clouds at {ratio}x over the "
            f"mesh: bit-equal to the mesh-less call {same}; launches "
            f"{nonzero(counts)} (expected {nonzero(want)})")
        require(same, f"multi_device upsample_many {ratio}x differs")
        require(counts == want, f"multi_device upsample_many {ratio}x "
                f"launches {counts}")
    return total


def md_eval_step(cfg, mesh):
    """The evaluation step (``train.steps.make_eval_step``) of the seeded
    generator on a batch of synthetic patches, over the mesh and without
    it: coarse and fine points and the metrics bit-equal, with the same
    launches."""
    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.data.dataset import synthetic_patches
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_eval_step

    bs = cfg.train.batch_size
    g = cfg.generator
    _, gt, radius = (torch.from_numpy(a).cuda() for a in
                     synthetic_patches(bs, g.num_out_points, seed=1))
    inputs = gt[:, ::g.num_out_points // g.num_points].contiguous()
    model = create_generator_state(cfg.generator, seed=0,
                                   device="cuda").model
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        kernels.reset_launch_counts()
        coarse, fine, metrics = make_eval_step(cfg, mesh=m)(
            model, inputs, gt, radius)
        runs[name] = (coarse, fine, {k: float(v) for k, v in
                                     metrics.items()},
                      kernels.launch_counts())
    (c0, f0, m0, n0), (c1, f1, m1, n1) = runs["plain"], runs["mesh"]
    same = torch.equal(c0, c1) and torch.equal(f0, f1) and m0 == m1
    log(f"multi_device eval step, batch {bs}: points and metrics bit-equal "
        f"to the mesh-less step {same}; launches {nonzero(n1)}")
    require(same, "multi_device eval step differs")
    require(n1 == n0 and nonzero(n1), f"multi_device eval step launches "
            f"{n1} != {n0}")
    return n1


def md_merge(mesh):
    """The sharded bucketed merge on a 16× request's merge candidates:
    bit-equal to the call without a mesh."""
    import torch

    from dispu_tpu_torch import InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.ops.sampling import farthest_point_sample_bucketed

    up = PatchUpsampler(seed=0, inf_cfg=InferenceConfig(final_ratio=16))
    _, cand, out_num, _, _ = merge_candidates(
        up, load_cloud("Icosahedron.xyz")[None])
    k = InferenceConfig().merge_fps_buckets
    with torch.inference_mode():
        kernels.reset_launch_counts()
        got = farthest_point_sample_bucketed(out_num, cand, n_buckets=k,
                                             mesh=mesh)
        counts = kernels.launch_counts()
        want = farthest_point_sample_bucketed(out_num, cand, n_buckets=k)
    same = torch.equal(got, want)
    log(f"multi_device sharded bucketed merge: {out_num} of "
        f"{cand.shape[1]} candidates in {k} buckets, bit-equal to the "
        f"mesh-less call {same}; launches {nonzero(counts)}")
    require(same, "multi_device sharded merge differs")
    require(counts["fps_bucketed"] == 1, f"sharded merge launches {counts}")
    return counts


def md_eval(mesh):
    """``sharded_cd_hd`` of the demo outputs against demo/gt, on the clouds
    ``cd_hd`` normalizes, within ``MD_EVAL_REL`` of ``cd_hd``."""
    import numpy as np
    import torch

    from dispu_tpu_torch.evaluation.metrics import cd_hd
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud
    from dispu_tpu_torch.parallel.sharded_eval import sharded_cd_hd

    worst = 0.0
    for name in ("Icosahedron", "fandisk"):
        gt = torch.from_numpy(load_cloud(f"{name}.xyz")).cuda()
        for ratio in (4, 16):
            path = os.path.join(REPO, "demo", "outputs",
                                f"{name}_X{ratio}.xyz")
            pred = torch.from_numpy(np.loadtxt(path, dtype=np.float32)[
                :, :3]).cuda()
            with torch.inference_mode():
                want = [float(v) for v in cd_hd(pred, gt)]
                got = [float(v) for v in sharded_cd_hd(
                    mesh, normalize_point_cloud(pred)[0],
                    normalize_point_cloud(gt)[0])]
            rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
            worst = max(worst, rel)
            log(f"multi_device sharded_cd_hd {name}_X{ratio} "
                f"({pred.shape[0]} vs {gt.shape[0]} points): (cd, hd) "
                f"{got} against cd_hd {want}, rel {rel:.3e}")
    require(worst <= MD_EVAL_REL, f"sharded_cd_hd deviates {worst}")


def md_all_reduce(card: str, mesh):
    """The default generator's gradient all-reduce as a step makes it
    (``train.steps.reduce_grads_``: ``all_reduce_mean_`` of the 68
    gradients, flattened into one buffer, all-reduced, divided and copied
    back) beside a bare ``dist.all_reduce`` of the same 4.19 MB, by CUDA
    events over 200 calls each."""
    import torch
    import torch.distributed as dist

    from dispu_tpu_torch.models.generator import DisPUGenerator
    from dispu_tpu_torch.train.steps import reduce_grads_

    model = DisPUGenerator(impl="torch").cuda()
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    grads = [p.grad for p in model.parameters()]
    n = sum(g.numel() for g in grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    group = mesh.get_group(0)
    step_ms = timed_ms(lambda: reduce_grads_(model, mesh), 200)
    bare_ms = timed_ms(lambda: dist.all_reduce(flat, group=group), 200)
    log(f"multi_device gradient all-reduce, {len(grads)} gradients, {n} "
        f"f32 weights ({4 * n / 1e6:.2f} MB), world size 1 over "
        f"{dist.get_backend()}: a step's reduce_grads_ "
        f"{step_ms * 1e3:.1f} us, bare dist.all_reduce "
        f"{bare_ms * 1e3:.1f} us; on {card}")


def multi_device(card: str) -> dict:
    """The mesh paths at world size 1 on the card, over NCCL: a one-rank
    group (``file://`` init) and ``make_mesh(device="cuda")``, destroyed in
    a ``finally``; each mesh path bit-equal to its mesh-less run with its
    launches (NCCL refuses two ranks on one device, so ranks > 1 run on
    the CPU only, in the tests and ``parallel.dryrun``)."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from dispu_tpu_torch import cli, kernels
    from dispu_tpu_torch.config import ExperimentConfig, TrainConfig
    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.parallel.mesh import make_mesh
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step
    from dispu_tpu_torch.train.trainer import Trainer, state_tensors
    from dispu_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                  restore_checkpoint)

    t_phase = time.perf_counter()
    require(not dist.is_initialized(), "a process group exists already")
    tmp = tempfile.mkdtemp(prefix="md_group_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/group",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cuda")
        log(f"multi_device: {mesh} over {dist.get_backend()}")
        cfg = ExperimentConfig()
        counts = md_train_steps(
            card, mesh, "CD step", cfg,
            lambda: create_generator_state(cfg.generator, seed=0,
                                           device="cuda"),
            lambda m: make_train_step(cfg, mesh=m),
            expected_train_counts(cfg), checked=3, timed=30)
        gcfg = cli.build_config(cli.parse_args(
            ["--phase", "train", "--use_gan", "true", "--d_clip", "0"]))
        c = md_train_steps(
            card, mesh, "GAN step (d_clip 0)", gcfg,
            lambda: create_gan_state(gcfg, seed=0, device="cuda"),
            lambda m: make_gan_train_step(gcfg, mesh=m),
            expected_gan_counts(gcfg), checked=2, timed=20)
        counts = add_counts(counts, c)

        # the trainer over the mesh: one epoch of 2 steps, its checkpoint
        # restores bit-equal, and its state is the mesh-less trainer's
        states = {}
        for name, m in (("mesh", mesh), ("plain", None)):
            log_dir = os.path.join(REPO, "chiprun_out", f"md_trainer_{name}")
            shutil.rmtree(log_dir, ignore_errors=True)
            tcfg = dataclasses.replace(cfg, log_dir=log_dir,
                                       train=dataclasses.replace(
                                           TrainConfig(), epoch_per_save=1))
            ds = PatchDataset(h5_path=os.path.join(log_dir, "absent.h5"),
                              synthetic_patches_count=2 * cfg.train.batch_size,
                              seed=0)
            kernels.reset_launch_counts()
            states[name] = Trainer(tcfg, dataset=ds, mesh=m).train(epochs=1)
            c = kernels.launch_counts()
            want = add_counts({}, expected_train_counts(cfg), 2)
            require(c == want, f"multi_device trainer ({name}) launches {c}")
            if m is not None:
                counts = add_counts(counts, c)
                epoch, path = latest_checkpoint(log_dir)
                back = restore_checkpoint(path, create_generator_state(
                    cfg.generator, seed=11, device="cuda"))
                same = all(torch.equal(a, b) for a, b in zip(
                    state_tensors(states[name].state_dict()),
                    state_tensors(back.state_dict())))
                require(epoch == 1 and same,
                        "multi_device trainer checkpoint does not restore")
        same = all(torch.equal(a, b) for a, b in zip(
            state_tensors(states["mesh"].state_dict()),
            state_tensors(states["plain"].state_dict())))
        log(f"multi_device Trainer(mesh=mesh).train(epochs=1), 2 steps: "
            f"checkpoint restores bit-equal; state bit-equal to the "
            f"mesh-less trainer's {same}")
        require(same, "multi_device trainer differs from the mesh-less one")

        counts = add_counts(counts, md_eval_step(cfg, mesh))
        counts = add_counts(counts, md_serve(card, mesh))
        counts = add_counts(counts, md_merge(mesh))
        md_eval(mesh)
        md_all_reduce(card, mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    require(not dist.is_initialized(), "the process group outlived the phase")
    log(f"multi_device phase: {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")
    return counts


# ------------------------------------------ phase 4: PR-18 slice's phases

# the approximate EMD on the card against the same call on the CPU: the
# two round the squared distances d apart (other sum orders), and the
# coldest level, -4^7, turns one f32 round-off of d (3.2e-8 at d ≤ 0.27,
# the clouds' span) into 16384 × 3.2e-8 = 5.3e-4 of a kernel entry
# exp(level·d), which the rounds carry into the match and the cost alike;
# each is held at 1e-3 (of the match's largest entry; of the cost).  The
# first reading on an H100 at 700 W: match 1.5e-4, cost 1.9e-4 (a cost
# limit of 1e-4, set below this bound before any reading, failed it).
# Both sides run the same torch code, so the check sees the card drift
# from the CPU, not a wrong EMD (the CPU tests hold that against JAX); a
# control run on the card with the squared distances rounded to bf16 must
# fail the limits, or they could not tell that from f32.  On an H100 at
# 700 W the control's match was 1.6e-2 (fails), its cost 2.2e-4 (the f32
# reading's 1.9e-4): the match's limit tells the two apart, the cost's
# bounds drift only.  (TF32 products are no control: they gave the f32
# reading to the digit, as this EMD's products, (n, 3) x (3, m) and
# matrix-vector, run no TF32.)
EMD_MATCH_REL = 1e-3
EMD_COST_REL = 1e-3


def serve_export_mesh(card: str) -> dict:
    """The SPMD serving export at world size 1 on the card: a one-process
    NCCL group (``file://`` init) and ``make_mesh(device="cuda")``, the
    port's seeded init exported at 4× and 16× for demo/gt/Icosahedron.xyz
    on the (1, 1) mesh into ``chiprun_out/serve_export_mesh/``.  Each
    entry records ``nr_devices`` 1 and the default group, its graph holds
    the functional all-gather and the ``dispu_tpu_torch::`` ops of
    ``serve_export``'s mesh-less entry of the same setting; served, it
    returns the live mesh path's bits and the mesh-less entry's, with the
    live call's launches; then served and live in turns, ms each.  Runs
    after ``serve_export``, whose artifacts it reads."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from dispu_tpu_torch import InferenceConfig, kernels
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.parallel.mesh import make_mesh
    from dispu_tpu_torch.serving import ServedUpsampler, export_upsampler

    t_phase = time.perf_counter()
    work = os.path.join(REPO, "chiprun_out", "serve_export_mesh")
    shutil.rmtree(work, ignore_errors=True)
    pc = load_cloud("Icosahedron.xyz")
    n = pc.shape[0]
    require(not dist.is_initialized(), "a process group exists already")
    tmp = tempfile.mkdtemp(prefix="spmd_group_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/group",
                            rank=0, world_size=1)
    total = {}
    try:
        mesh = make_mesh(device="cuda")
        for label, ratio in (("4x", 4), ("16x", 16)):
            inf = InferenceConfig(final_ratio=ratio)
            up = PatchUpsampler(seed=0, inf_cfg=inf, mesh=mesh)
            path = os.path.join(work, label)
            t0 = time.perf_counter()
            manifest = export_upsampler(up.model.state_dict(), [n], path,
                                        inf_cfg=inf, mesh=mesh)
            seconds = time.perf_counter() - t0
            entry = manifest["entries"][0]
            plain_path = os.path.join(REPO, "chiprun_out", "serve_export",
                                      label)
            with open(os.path.join(plain_path, "manifest.json")) as f:
                plain_entry = json.load(f)["entries"][0]
            require((entry["nr_devices"], entry["group"]) == (1, "0"),
                    f"serve_export_mesh {label}: entry {entry}")
            require("_c10d_functional::all_gather_into_tensor"
                    in entry["collectives"],
                    f"serve_export_mesh {label}: no all-gather in "
                    f"{entry['collectives']}")
            require(entry["kernels"] == plain_entry["kernels"],
                    f"serve_export_mesh {label}: ops {entry['kernels']} != "
                    f"the mesh-less entry's {plain_entry['kernels']}")
            want = expected_counts(up, n)
            kernels.reset_launch_counts()
            live = up.upsample(pc)
            counts = kernels.launch_counts()
            require(counts == want, f"serve_export_mesh {label}: live "
                    f"launches {counts} != {want}")
            served = ServedUpsampler(path)
            t0 = time.perf_counter()
            served.warmup()
            warm_s = time.perf_counter() - t0
            kernels.reset_launch_counts()
            out = served.upsample(pc)
            got = kernels.launch_counts()
            require(got == counts, f"serve_export_mesh {label}: served "
                    f"launches {got} != live's {counts}")
            require(np.array_equal(out, live),
                    f"serve_export_mesh {label}: served != live mesh path")
            require(np.array_equal(out, ServedUpsampler(plain_path)
                                   .upsample(pc)),
                    f"serve_export_mesh {label}: served != the mesh-less "
                    "entry")
            total = add_counts(total, counts)
            total = add_counts(total, got)
            reps = 3 if ratio == 16 else 5
            laps = {"live": [], "served": []}
            for rep in range(reps + 1):  # the first round warms both
                for kind, fn in (("live", up.upsample),
                                 ("served", served.upsample)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(pc)  # returns on the host: synchronized
                    if rep:
                        laps[kind].append((time.perf_counter() - t0) * 1e3)
            med = {k: statistics.median(v) for k, v in laps.items()}
            nbytes = os.path.getsize(os.path.join(path, entry["file"]))
            log(f"serve_export_mesh {label}: exported on the (1, 1) NCCL "
                f"mesh in {seconds:.2f} s, {nbytes} bytes, nr_devices 1, "
                f"{entry['collectives']}, ops {entry['kernels']} (= the "
                f"mesh-less entry's); warmup {warm_s:.2f} s; served "
                f"bit-equal to the live mesh path and to the mesh-less "
                f"entry, launches {nonzero(got)} (= live); ms per "
                f"{n}-point request in turns, median of {reps}: live "
                f"{med['live']:.2f} ({', '.join('%.2f' % t for t in laps['live'])}"
                f"), served {med['served']:.2f} ("
                f"{', '.join('%.2f' % t for t in laps['served'])}), served "
                f"/ live {med['served'] / med['live']:.3f} on {card}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    require(not dist.is_initialized(), "the process group outlived the phase")
    log(f"serve_export_mesh: {time.perf_counter() - t_phase:.1f} s")
    return total


def _kernel_names(trace_path: str) -> set:
    """The device kernels' names in a Chrome trace of ``torch.profiler``."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def train_utilities(card: str) -> dict:
    """The trainer's host-side utilities at full width, batch 28, on
    synthetic patches: ``backup_sources(mode="copy")``, then one CD epoch
    of 2 steps with ``visualize`` (every 2 steps) and ``profile`` into
    ``chiprun_out/train_utilities/``, with the launches of 2 steps and one
    render's evaluation step.  The trace must name the kNN, attention and
    ball-query kernels by their ``__global__`` names, the PNG and the code
    copy must exist, and the trained state and each step's scalars must
    be bit-equal to the same epoch without either setting.  Then the
    epoch's wall seconds with the profiler alone and without, in turns."""
    import dataclasses
    import shutil
    import statistics

    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.config import ExperimentConfig, TrainConfig
    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.train.trainer import Trainer, state_tensors
    from dispu_tpu_torch.utils.logging import backup_sources

    t_phase = time.perf_counter()
    work = os.path.join(REPO, "chiprun_out", "train_utilities")
    shutil.rmtree(work, ignore_errors=True)
    base = ExperimentConfig()
    bs = base.train.batch_size

    def cfg_for(name, **train):
        return dataclasses.replace(base, log_dir=os.path.join(work, name),
                                   train=dataclasses.replace(
                                       TrainConfig(), epoch_per_save=1,
                                       steps_per_print=1, **train))

    def epoch(cfg):
        # a fresh patch set each time: its batch order is drawn from it
        dataset = PatchDataset(h5_path=os.path.join(work, "absent.h5"),
                               synthetic_patches_count=2 * bs, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = Trainer(cfg, dataset=dataset).train(epochs=1)
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    on = cfg_for("on", visualize=True, steps_per_visu=2, profile=True)
    backup_sources(on.log_dir, mode="copy")
    copy = os.path.join(on.log_dir, "code", "dispu_tpu_torch")
    require(os.path.isfile(os.path.join(copy, "kernels", "csrc", "knn.cu"))
            and os.path.isfile(os.path.join(copy, "native.py")),
            f"backup_sources(mode='copy') wrote no copy at {copy}")
    kernels.reset_launch_counts()
    state_on, on_s = epoch(on)
    counts = kernels.launch_counts()
    render = expected_forward_counts(base)[0]
    render["knn"] += 6  # the evaluation step's Chamfer and Hausdorff
    want = add_counts(add_counts({}, expected_train_counts(base), 2), render)
    require(counts == want, f"train_utilities launches {counts} != {want}")
    names = _kernel_names(os.path.join(on.log_dir, "profile", "trace.json"))
    for kind, part in (("kNN", "knn"), ("attention", "attention_kernel"),
                       ("ball query", "ball_kernel")):
        hits = sorted(n for n in names if part in n)
        require(hits, f"the trace names no {kind} kernel ({part}) among "
                f"{sorted(names)[:40]}")
        log(f"train_utilities trace: {kind} kernels {hits}")
    png = os.path.join(on.log_dir, "plots", "epoch_0_step_2.png")
    require(os.path.isfile(png), f"no render at {png}")

    off = cfg_for("off")
    kernels.reset_launch_counts()
    state_off, off_s = epoch(off)
    require(all(torch.equal(a, b) for a, b in zip(
        state_tensors(state_on.state_dict()),
        state_tensors(state_off.state_dict()))),
        "the epoch with visualize and profile trained another state")

    def scalars(cfg):
        with open(os.path.join(cfg.log_dir, "scalars.jsonl")) as f:
            return [{k: v for k, v in json.loads(ln).items()
                     if k not in ("time", "steps_per_sec")} for ln in f]

    require(scalars(on) == scalars(off) and len(scalars(on)) == 2,
            f"the steps' scalars differ: {scalars(on)} {scalars(off)}")
    # the profiler's cost on an epoch: profile alone against neither
    laps = {"profile": [], "plain": []}
    for rep in range(2):
        for kind in (("profile", "plain") if rep == 0
                     else ("plain", "profile")):
            cfg = cfg_for(f"{kind}{rep}", profile=kind == "profile")
            laps[kind].append(epoch(cfg)[1])
            shutil.rmtree(cfg.log_dir)  # timing only: keep chiprun_out small
    med = {k: statistics.median(v) for k, v in laps.items()}
    log(f"train_utilities: one epoch of 2 steps of batch {bs} with "
        f"visualize and profile {on_s:.2f} s, without {off_s:.2f} s "
        f"(state and scalars bit-equal); launches {nonzero(counts)}; "
        f"render {os.path.getsize(png)} bytes, trace "
        f"{os.path.getsize(os.path.join(on.log_dir, 'profile', 'trace.json'))}"
        f" bytes; epoch s in turns, profile alone "
        f"{', '.join('%.2f' % t for t in laps['profile'])}, plain "
        f"{', '.join('%.2f' % t for t in laps['plain'])} (profile / plain "
        f"{med['profile'] / med['plain']:.3f}) on {card}")
    log(f"train_utilities: {time.perf_counter() - t_phase:.1f} s")
    return counts


def _rank_near_ties(label, got, want, centre, rtol):
    """Rows of (b, s, k, 3) neighbourhoods ``got`` and ``want`` of (b, s,
    3) centres, rank by rank: their squared distances to the centre (the
    expansion, as the kNN computes them) must agree to ``rtol`` of its
    scale, so that any row that differs is a near-tie swap.  Returns the
    number of differing rows."""
    import torch

    from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

    def dist(rows):
        return pairwise_sq_dist(centre[..., None, :], rows)[..., 0, :]

    scale = 2.0 * float(torch.amax(torch.sum(want * want, -1)))
    dg, dw = dist(got), dist(want)
    err = float((torch.abs(dg - dw) / (torch.abs(dw) + scale)).max())
    require(err <= rtol, f"{label}: a row differs beyond a near-tie ({err})")
    return int((got != want).any(-1).sum())


def ops_21(card: str) -> dict:
    """The point-set ops of the JAX package's ``ops/`` (patches, dilated
    grouping, three-NN, the approximate EMD) on the card, each through the
    kernels against the same call through the plain versions (impl
    'torch'), with its launches; selections equal except near-ties under
    phase 3's contract (``KNN_SWAP_RTOL``), FPS seeds bit-equal.  Then the
    EMD on the card against the CPU, and the native host library built
    from ``dispu_tpu_torch/csrc/`` with g++ and called once, its kNN
    against the kNN kernel's."""
    import numpy as np
    import torch

    from dispu_tpu_torch import kernels, native
    from dispu_tpu_torch.ops import emd
    from dispu_tpu_torch.ops.geometry import (normalize_point_cloud,
                                              pairwise_sq_dist)
    from dispu_tpu_torch.ops.grouping import dilat_group
    from dispu_tpu_torch.ops.interpolate import three_nn
    from dispu_tpu_torch.ops.knn import knn
    from dispu_tpu_torch.ops.patches import (extract_patches_test,
                                             extract_patches_train)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(21)
    clouds = np.stack([load_cloud("Icosahedron.xyz"),
                       load_cloud("fandisk.xyz")])
    pcs, _, _ = normalize_point_cloud(torch.from_numpy(clouds).to(dev))
    # a denser ground truth around each cloud: 4 jittered copies
    gt = (pcs.repeat(1, 4, 1) + 0.01 * torch.randn(
        2, 4 * pcs.shape[1], 3, generator=gen).to(dev)).contiguous()
    counts, lines = {}, []

    def through(fn, want_counts, label):
        kernels.reset_launch_counts()
        out = fn("auto")
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        want = dict(dict.fromkeys(kernels.LAUNCHES, 0), **want_counts)
        require(got == want, f"ops_21 {label}: launches {got} != {want}")
        counts.update(add_counts(counts, got))
        return out, fn("torch")

    # patches for training: 24 FPS seeds a cloud, 256-point patches, and
    # 1024-point ground-truth patches around the same seeds (k 1024 over
    # 8,192 points: the kNN radix form's 'split' regime)
    (kp, _, kg), (pp, _, pg) = through(
        lambda impl: extract_patches_train(pcs, 256, patch_num=24,
                                           gt_xyz=gt, gt_k=1024, impl=impl),
        dict(fps=1, knn=1, knn_split=1), "extract_patches_train")
    # patch-major: rows j·b + v hold cloud v's patch j
    require(torch.equal(kp[:, 0], pp[:, 0]),
            "extract_patches_train: the seeds (each patch's row 0) differ")
    seeds = pp[:, 0]  # each patch's nearest point is its seed
    swaps = [_rank_near_ties("extract_patches_train", k, p, seeds,
                             KNN_SWAP_RTOL) for k, p in ((kp, pp), (kg, pg))]
    lines.append(f"extract_patches_train (2 x 2048 -> 24 x 256, gt 2 x 8192 "
                 f"-> 24 x 1024): seeds bit-equal, near-tie rows {swaps}")
    # patches for testing: the outlier filter, FPS, kNN of one cloud
    (kt, ks), (pt, ps) = through(
        lambda impl: extract_patches_test(clouds[0], 256, impl=impl),
        dict(fps=1, knn=2), "extract_patches_test")
    require(kt.shape == pt.shape and np.array_equal(ks, ps),
            "extract_patches_test: the filtered cloud or the seeds differ")
    swaps = _rank_near_ties("extract_patches_test", torch.from_numpy(kt),
                            torch.from_numpy(pt), torch.from_numpy(ps),
                            KNN_SWAP_RTOL)
    lines.append(f"extract_patches_test (2048 -> {kt.shape[0]} x 256): "
                 f"seeds bit-equal, near-tie rows {swaps}")
    # the dilated grouping at a backbone's shape, and three-NN at a
    # PointNet++ feature propagation's
    xyz = torch.randn(28, 1024, 3, generator=gen).to(dev)
    feats = torch.randn(28, 1024, 64, generator=gen).to(dev)
    (kx, kf, ki), (px, pf, pi) = through(
        lambda impl: dilat_group(xyz, feats, 16, dilation=2, use_xyz=True,
                                 impl=impl), dict(knn=1), "dilat_group")
    swaps = _rank_near_ties("dilat_group", kx + xyz[:, :, None],
                            px + xyz[:, :, None], xyz, KNN_SWAP_RTOL)
    same = ki == pi
    require(torch.equal(kf[same], pf[same]), "dilat_group: gathered rows at "
            "equal indices differ")
    lines.append(f"dilat_group (28 x 1024, k 16, dilation 2, 64 channels): "
                 f"near-tie swaps {int((~same).sum())} of {ki.numel()}")
    queries = torch.randn(28, 1024, 3, generator=gen).to(dev)
    source = torch.randn(28, 256, 3, generator=gen).to(dev)
    (kd, kn), (pd, pn) = through(lambda impl: three_nn(queries, source,
                                                       impl=impl),
                                 dict(knn=1), "three_nn")
    swaps = _near_tie_swaps("three_nn", kn, pn, source, queries, None,
                            KNN_SWAP_RTOL)
    scale = 2.0 * float(torch.amax(torch.sum(source * source, -1)))
    dist_err = float((torch.abs(kd - pd) / (torch.abs(pd) + scale)).max())
    require(dist_err <= KNN_DIST_RTOL, f"three_nn distances {dist_err}")
    lines.append(f"three_nn (28 x 1024 queries, 256 points): near-tie "
                 f"swaps {swaps}, distances {dist_err:.2e} of the scale")
    # the approximate EMD at a training batch's clouds, card against CPU
    pred = torch.rand(4, 1024, 3, generator=gen) * 0.3
    ref = torch.rand(4, 1024, 3, generator=gen) * 0.3
    t0 = time.perf_counter()
    match = emd.approx_match(pred.to(dev), ref.to(dev))
    cost = emd.earth_mover_cost(pred.to(dev), ref.to(dev))
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu_match = emd.approx_match(pred, ref)
    cpu_cost = emd.earth_mover_cost(pred, ref)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    m_err = float((match.cpu() - cpu_match).abs().max()
                  / cpu_match.abs().max())
    c_err = abs(float(cost) - float(cpu_cost)) / abs(float(cpu_cost))
    require(m_err <= EMD_MATCH_REL and c_err <= EMD_COST_REL,
            f"EMD card vs CPU: match {m_err}, cost {c_err}")
    lines.append(f"EMD (4 x 1024 vs 1024): card vs CPU match {m_err:.2e} of "
                 f"its largest (limit {EMD_MATCH_REL:.0e}), cost rel "
                 f"{c_err:.2e} (limit {EMD_COST_REL:.0e}); card {card_ms:.1f}"
                 f" ms with the first call, CPU {cpu_ms:.1f} ms")
    # the control: the same on the card, the squared distances in bf16
    emd.pairwise_sq_dist = lambda x, y: pairwise_sq_dist(
        x, y).bfloat16().float()
    try:
        ctl_match = emd.approx_match(pred.to(dev), ref.to(dev)).cpu()
        ctl_cost = float(emd.earth_mover_cost(pred.to(dev), ref.to(dev)))
    finally:
        emd.pairwise_sq_dist = pairwise_sq_dist
    tm_err = float((ctl_match - cpu_match).abs().max()
                   / cpu_match.abs().max())
    tc_err = abs(ctl_cost - float(cpu_cost)) / abs(float(cpu_cost))
    require(tm_err > EMD_MATCH_REL or tc_err > EMD_COST_REL,
            f"the EMD limits pass bf16 distances: match {tm_err}, cost "
            f"{tc_err} (f32: match {m_err}, cost {c_err})")
    lines.append(f"EMD control, the squared distances in bf16: match "
                 f"{tm_err:.2e}, cost rel {tc_err:.2e} (fails the limits, "
                 "as it must)")
    # the native host library: built here with g++, its exact KD-tree kNN
    # against the kNN kernel's selection
    t0 = time.perf_counter()
    try:
        native.build()
    except RuntimeError as e:
        require(False, f"the native library does not build: {e}")
    build_s = time.perf_counter() - t0
    pts = pcs[:1].contiguous()
    nidx = torch.from_numpy(native.knn_batch(pts.cpu().numpy(),
                                             pts.cpu().numpy(), 16)).to(dev)
    kernels.reset_launch_counts()
    _, kidx = knn(16, pts, pts)
    counts = add_counts(counts, kernels.launch_counts())
    swaps = _near_tie_swaps("native knn_batch", nidx, kidx, pts, pts, None,
                            KNN_SWAP_RTOL)
    lines.append(f"native: built in {build_s:.1f} s, knn_batch (2048, k 16) "
                 f"against knn.cu: near-tie swaps {swaps}")
    for line in lines:
        log(f"ops_21 {line}")
    log(f"ops_21: {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts


# ---------------------------------- phase 4: ROADMAP 21's network modules

# ROADMAP 21's network modules on the card.  Each runs once through the
# kernels with every selection it makes recorded (the site, its inputs,
# its result); each recorded selection is held against the plain version
# on the same inputs (FPS bit-equal; kNN and three-NN swaps only between
# near-ties, KNN_SWAP_RTOL, three-NN distances KNN_DIST_RTOL; the ball
# query under check_query_ball's contract); then the module runs through
# the plain versions with the kernel run's selections replayed, so that
# the outputs differ only where a kernel other than a selection computes
# values (the refiner's attention and fused local branch): max |d| over
# the output's max |x|.  Readings on an H100 at 700 W: 0 where the
# selections are all a kernel does (replayed, the rest is the same torch
# code); the ball refiner 9.6e-7 in training (attention.cu against its
# plain bf16 emulation) and 4.3e-6 in eval with 'fused' (refine_local.cu's
# 3xTF32 sums too).  The refiner's limit is an order above its readings.
NETS_REL = {"exact": 1e-6, "refiner": 5e-5}
# the modules' and the losses' selection sites: (module, name, what it
# selects)
SELECTION_SITES = (
    ("dispu_tpu_torch.nn.pointnet", "farthest_point_sample", "fps"),
    ("dispu_tpu_torch.nn.pointnet", "query_ball_point", "ball"),
    ("dispu_tpu_torch.nn.pointnet", "knn_indices", "knn"),
    ("dispu_tpu_torch.nn.pointnet", "three_nn", "three_nn"),
    ("dispu_tpu_torch.nn.gcn", "knn_indices", "knn"),
    ("dispu_tpu_torch.nn.experimental", "farthest_point_sample", "fps"),
    ("dispu_tpu_torch.nn.edgeconv", "knn_unique_indices", "knn_unique"),
    ("dispu_tpu_torch.ops.grouping", "knn_indices", "knn"),
    ("dispu_tpu_torch.ops.grouping", "query_ball_point", "ball"),
    ("dispu_tpu_torch.losses", "farthest_point_sample", "fps"),
    ("dispu_tpu_torch.losses", "knn_indices", "knn"),
    ("dispu_tpu_torch.losses", "query_ball_point", "ball"),
    ("dispu_tpu_torch.losses", "knn", "knn_dists"),
    ("dispu_tpu_torch.ops.chamfer", "directed_argmin", "argmin"),
)


class SelectionTape:
    """Inside ``with tape.recording()`` every selection site of
    SELECTION_SITES records (what, function, args, kwargs, result); inside
    ``with tape.replaying()`` each site returns the next recorded result
    instead, in order, and every recording must be used."""

    def __init__(self):
        self.records = []

    @contextlib.contextmanager
    def _sites(self, make):
        saved = []
        for mod_name, name, what in SELECTION_SITES:
            mod = importlib.import_module(mod_name)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, make(getattr(mod, name), what))
        try:
            yield
        finally:
            for mod, name, orig in saved:
                setattr(mod, name, orig)

    @contextlib.contextmanager
    def recording(self):
        self.records = []

        def make(orig, what):
            def site(*args, **kwargs):
                out = orig(*args, **kwargs)
                self.records.append((what, orig, args, kwargs, out))
                return out
            return site

        with self._sites(make):
            yield

    @contextlib.contextmanager
    def replaying(self):
        queue = list(self.records)

        def make(orig, what):
            def site(*args, **kwargs):
                require(bool(queue), f"replay: no recorded {what} left")
                rec = queue.pop(0)
                require(rec[0] == what and rec[1] is orig,
                        f"replay: {what} called where {rec[0]} was recorded")
                return rec[4]
            return site

        with self._sites(make):
            yield
        require(not queue, f"replay left {len(queue)} selections unused")


def _ball_contract(label, got, want, radius, xyz, qs):
    """The ball query's (idx, counts) against the plain version's on the
    same inputs: rows may differ only where a point's plain distance lies
    within QB_TIE_RTOL of r² (check_query_ball's hit-boundary contract).
    Returns the number of differing rows."""
    import torch

    from dispu_tpu_torch.ops.geometry import pairwise_sq_dist

    d = pairwise_sq_dist(qs, xyz)
    scale = (torch.sum(qs * qs, -1)[..., None]
             + torch.sum(xyz * xyz, -1)[:, None, :])
    r2 = float(torch.tensor(radius, dtype=torch.float32) ** 2)
    boundary = torch.any(torch.abs(d - r2) <= QB_TIE_RTOL * (r2 + scale),
                         dim=-1)
    rows_ok = torch.all(got[0] == want[0], dim=-1) & (got[1] == want[1])
    require(bool(torch.all(rows_ok | boundary)),
            f"{label}: ball rows differ away from the hit boundary")
    return int((~rows_ok).sum())


def hold_selections(label, tape) -> dict:
    """Each selection the kernel run recorded against the plain version on
    the same inputs, under phase 3's contracts.  Returns {what: (calls,
    differing rows or indices)}."""
    import torch

    out = {}
    for what, fn, args, kwargs, got in tape.records:
        args = [a.detach() if torch.is_tensor(a) else a for a in args]
        want = fn(*args, **dict(kwargs, impl="torch"))
        tag = f"{label} {what}"
        if what == "fps":
            require(torch.equal(got, want), f"{tag}: seeds differ")
            diff = 0
        elif what == "knn":
            diff = _near_tie_swaps(tag, got, want, args[1], args[2], None,
                                   KNN_SWAP_RTOL)
        elif what == "knn_unique":  # duplicate rows biased last
            from dispu_tpu_torch.ops.knn import mask_duplicate_rows

            bias = mask_duplicate_rows(args[1].float()).float() * 1e30
            diff = _near_tie_swaps(tag, got, want, args[1].float(),
                                   args[2].float(), bias, KNN_SWAP_RTOL)
        elif what == "argmin":  # the chamfer's nearest b row of each a row
            diff = _near_tie_swaps(tag, got[..., None], want[..., None],
                                   args[1], args[0], None, KNN_SWAP_RTOL)
        elif what == "knn_dists":  # (distances, indices)
            pts, qs = args[1], args[2]
            diff = _near_tie_swaps(tag, got[1], want[1], pts, qs, None,
                                   KNN_SWAP_RTOL)
            scale = 2.0 * float(torch.amax(torch.sum(pts * pts, -1)))
            err = float((torch.abs(got[0].detach() - want[0])
                         / (torch.abs(want[0]) + scale)).max())
            require(err <= KNN_DIST_RTOL, f"{tag}: distances {err}")
        elif what == "three_nn":
            pts, qs = args[1], args[0]
            k = min(3, pts.shape[1])  # fewer points: the nearest repeated
            diff = _near_tie_swaps(tag, got[1][..., :k], want[1][..., :k],
                                   pts, qs, None, KNN_SWAP_RTOL)
            scale = 2.0 * float(torch.amax(torch.sum(pts * pts, -1)))
            err = float((torch.abs(got[0] - want[0])
                         / (torch.abs(want[0]) + scale)).max())
            require(err <= KNN_DIST_RTOL, f"{tag}: distances {err}")
        else:
            diff = _ball_contract(tag, got, want, args[0], args[2], args[3])
        calls, total = out.get(what, (0, 0))
        out[what] = (calls + 1, total + diff)
    return out


def set_impl(module, impl: str):
    """Every submodule's ``impl`` (the kernels' 'auto', or 'torch')."""
    for m in module.modules():
        if hasattr(m, "impl"):
            m.impl = impl
    return module


def nets_21(card: str) -> dict:
    """ROADMAP 21's network modules at their published defaults, from the
    port's seeded init, on the card: ``HierarchyFeatureExtractor()`` on 28
    ground-truth patches of 1024 points (``synthetic_patches``),
    ``HierarchyUpsampler()`` on 28 × 256 → 1024, ``GCNBackbone(conv=c)``
    for each conv on 28 × 256 (its third graph at k·d = 48: ``knn.cu``'s
    radix form on 24-wide features), ``UpProjectionUnit()`` on the
    ``GeneratorConfig()`` backbone's features of 28 × 256 patches, and
    ``PointShuffle2(use_knn=False)`` at the refiner's width on 28 × 1024
    in training and in eval with ``local_impl='fused'``.  Each with exact
    launch counts, its selections against the plain versions and its
    output against the plain path on the kernels' selections (see
    ``NETS_REL``), and one backward (the refiner's in training) leaving
    every parameter a finite gradient.  Then the new kernel shapes timed
    beside their plain versions: the kNN radix form at k 48 on 24 channels,
    the ball query at the hierarchy's ns 64 and 32.  Returns the phase's
    launch counts."""
    import torch

    from dispu_tpu_torch import GeneratorConfig, kernels
    from dispu_tpu_torch.data.dataset import synthetic_patches
    from dispu_tpu_torch.kernels.knn import knn_cuda, knn_torch
    from dispu_tpu_torch.kernels.query_ball import (query_ball_cuda,
                                                    query_ball_torch)
    from dispu_tpu_torch.models.generator import DisPUGenerator
    from dispu_tpu_torch.nn.gcn import CONVS, GCNBackbone
    from dispu_tpu_torch.nn.hierarchy import (HierarchyFeatureExtractor,
                                              HierarchyUpsampler)
    from dispu_tpu_torch.nn.layers import init_weights
    from dispu_tpu_torch.nn.refine import PointShuffle2
    from dispu_tpu_torch.nn.upsample import UpProjectionUnit
    from dispu_tpu_torch.ops.sampling import farthest_point_sample

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(19)
    gt = torch.from_numpy(synthetic_patches(28, 1024, seed=0)[0]).to(dev)
    # 256-point inputs: each patch's FPS seeds (plain FPS, no launch)
    sparse = torch.gather(gt, 1, farthest_point_sample(
        256, gt, impl="torch").long()[..., None].expand(-1, -1, 3))
    gcfg = GeneratorConfig()
    gnet = DisPUGenerator(gcfg, seed=0).to(dev)
    with torch.no_grad():
        backbone = gnet.feature_extraction_coarse(sparse)
    refine_c = gnet.PointShuffle.skip.dense.in_features - 6
    feats = (0.5 * torch.randn(28, 1024, refine_c, generator=gen)).to(dev)
    counts, lines = {}, []

    def drive(label, module, inputs, want_counts, kind, train=False,
              backward=True):
        nonlocal counts
        init_weights(module, torch.Generator().manual_seed(0))
        module = module.to(dev).train(train)
        tape = SelectionTape()
        kernels.reset_launch_counts()
        with tape.recording():
            out = module(*inputs)
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        want = dict(dict.fromkeys(kernels.LAUNCHES, 0), **want_counts)
        require(got == want, f"nets_21 {label}: launches {got} != {want}")
        counts = add_counts(counts, got)
        sel = hold_selections(f"nets_21 {label}", tape)
        out = out[1] if isinstance(out, tuple) else out
        kernels.reset_launch_counts()
        with tape.replaying(), torch.no_grad():
            plain = set_impl(module, "torch")(*inputs)
        plain = plain[1] if isinstance(plain, tuple) else plain
        require(kernels.launch_counts() == dict.fromkeys(kernels.LAUNCHES, 0),
                f"nets_21 {label}: the plain run launched a kernel")
        require(bool(torch.isfinite(out).all()),
                f"nets_21 {label}: a non-finite output")
        rel = float((out.detach() - plain).abs().max()
                    / plain.abs().max().clamp_min(1e-30))
        require(rel <= NETS_REL[kind], f"nets_21 {label}: kernels vs plain "
                f"{rel} (limit {NETS_REL[kind]})")
        grads = ""
        if backward:
            module.zero_grad(set_to_none=True)
            torch.sum(out.float() ** 2).backward()
            bad = [name for name, p in module.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())]
            require(not bad, f"nets_21 {label}: no finite gradient at {bad}")
            grads = (f", backward: {sum(1 for _ in module.parameters())} "
                     "parameters with finite gradients")
        lines.append(
            f"{label}: out {tuple(out.shape)}, launches "
            f"{ {k: v for k, v in got.items() if v} }, selections (calls, "
            f"differing) {sel}, kernels vs plain on the kernels' "
            f"selections {rel:.2e} of the largest (limit "
            f"{NETS_REL[kind]:.0e}){grads}")

    drive("HierarchyFeatureExtractor", HierarchyFeatureExtractor(), [gt],
          dict(fps=3, query_ball=3, knn=4), "exact")
    drive("HierarchyUpsampler", HierarchyUpsampler(), [sparse],
          dict(fps=4, query_ball=4, knn=3), "exact")
    for conv in CONVS:
        drive(f"GCNBackbone(conv={conv!r})", GCNBackbone(conv=conv),
              [sparse], dict(knn=3), "exact")
    drive("UpProjectionUnit", UpProjectionUnit(backbone.shape[-1]),
          [backbone], {}, "exact")
    drive("PointShuffle2(use_knn=False), training",
          PointShuffle2(refine_c, use_knn=False), [gt, feats],
          dict(query_ball=1, attention=1), "refiner", train=True)
    drive("PointShuffle2(use_knn=False, local_impl='fused'), eval",
          PointShuffle2(refine_c, use_knn=False, local_impl="fused"),
          [gt, feats], dict(query_ball=1, attention=1, refine_local=1),
          "refiner", backward=False)

    # the new shapes, timed: the third GCN graph (28 x 256, 24 channels,
    # k 48, the radix form's 'row' regime) and the hierarchy's ball queries
    x24 = torch.randn(28, 256, 24, generator=gen).to(dev)
    dk, ik = knn_cuda(48, x24, x24)
    dp, ip = knn_torch(48, x24, x24)
    swaps = _near_tie_swaps("nets_21 knn k 48", ik, ip, x24, x24, None,
                            KNN_SWAP_RTOL)
    scale = 2.0 * float(torch.amax(torch.sum(x24 * x24, -1)))
    dist_err = float((torch.abs(dk - dp) / (torch.abs(dp) + scale)).max())
    require(dist_err <= KNN_DIST_RTOL, f"nets_21 knn k 48: distances "
            f"{dist_err}")
    ms = timed_ms(lambda: knn_cuda(48, x24, x24), reps=20)
    plain_ms = timed_ms(lambda: knn_torch(48, x24, x24), reps=5)
    library_ms = timed_ms(lambda: torch.topk(torch.cdist(x24, x24) ** 2, 48,
                                             dim=-1, largest=False), reps=5)
    b, n, c = x24.shape
    bms, by = bound(4 * 2 * b * n * c + 8 * b * n * 48,
                    b * n * n * (2 * c + 4), F32_FLOPS)
    lines.append(f"knn radix form (b={b} n={n} c={c} k=48): swaps {swaps}, "
                 f"distances {dist_err:.2e} of the scale, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cdist+topk "
                 f"{library_ms:.4f} ms, bound {bms:.3g} ms ({by})")
    for r, ns, pts, m in ((0.1, 64, gt, 1024), (0.05, 32, sparse, 256)):
        qs = pts[:, :m].contiguous()
        got = query_ball_cuda(r, ns, pts, qs)
        want = query_ball_torch(r, ns, pts, qs)
        rows = _ball_contract("nets_21 ball", got, want, r, pts, qs)
        ms = timed_ms(lambda: query_ball_cuda(r, ns, pts, qs), reps=20)
        plain_ms = timed_ms(lambda: query_ball_torch(r, ns, pts, qs),
                            reps=5)
        b, n, c = pts.shape
        full = want[1] == ns
        scanned = torch.where(full, want[0][..., -1].long() + 1, n)
        bms, by = bound(4 * (b * n * c + b * m * c + b * m * ns + b * m),
                        float(scanned.sum()) * (3 * c + 3), F32_FLOPS)
        lines.append(f"query_ball (b={b} n={n} m={m} r={r} ns={ns}): "
                     f"differing rows {rows}, mean hits "
                     f"{float(want[1].float().mean()):.2f}, kernel "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                     f"{bms:.5f} ms ({by})")
    for line in lines:
        log(f"nets_21 {line}")
    log(f"nets_21: {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts


# nets_21b's kernels-vs-plain limits, max |d| over the output's max |x| on
# the kernels' selections replayed: "exact" where the kernels only select
# (the rest is the same torch code), "attention" where the non-local cell
# runs attention.cu against its plain bf16 emulation (the refiner's limit:
# the same kernel at the same widths).  Readings on an H100 at 700 W: 0,
# and 2.5e-6 to 4.7e-6.
NETS_B_REL = {"exact": NETS_REL["exact"], "attention": NETS_REL["refiner"]}


def nets_21b(card: str) -> dict:
    """The last of the JAX package at full width, from the port's seeded
    init, on the card: ``nn/experimental.py``'s downscalers
    (``PointASNLSetAbstraction(npoint=256, nsample=16, mlp=(64, 64,
    128))``, ``PointDownscale``, ``2``, ``3``, ``3_1``, ``4`` and
    ``PointShuffleV1(nsample=8)``; the ASNL and ``PointDownscale3`` also
    with ``use_knn=False``) on 28 × 1024 ``synthetic_patches`` with the
    refiner's feature width; the up/shuffle family (``UpShuffleLayer`` of
    both variants, ``3``, ``4``, ``5``, ``DuplicateUpEdge``,
    ``DuplicateUp2``, ``PointUpscale(npoint=1024)``,
    ``WeightLearningUnit``, the coordinate unit, instance norm) on the
    ``GeneratorConfig()`` backbone's features of 28 × 256 FPS-seed
    patches; ``feature_extraction_up`` and ``_down`` on the seeds;
    ``EdgeConv`` and the dense-block variants; each with exact launch
    counts, its selections against the plain versions, its output
    against the plain path on the kernels' selections (``NETS_B_REL``)
    and one backward leaving every parameter a finite gradient.  Then
    the new losses on a 28 × 1024 prediction the same way.  Then the new
    kernel shapes timed beside their plain versions, ``cdist`` + ``topk``
    (the kNN) or SDPA (the attention), and their bounds.  Returns the
    phase's launch counts."""
    import torch
    import torch.nn.functional as F

    from dispu_tpu_torch import GeneratorConfig, kernels, losses
    from dispu_tpu_torch.data.dataset import synthetic_patches
    from dispu_tpu_torch.kernels.attention import (attention_cuda,
                                                   attention_torch)
    from dispu_tpu_torch.kernels.fps import fps_cuda, fps_torch
    from dispu_tpu_torch.kernels.knn import knn_cuda, knn_torch
    from dispu_tpu_torch.kernels.query_ball import (query_ball_cuda,
                                                    query_ball_torch)
    from dispu_tpu_torch.models.generator import DisPUGenerator
    from dispu_tpu_torch.nn import experimental as ex
    from dispu_tpu_torch.nn.edgeconv import DenseEdgeBlock, EdgeConv
    from dispu_tpu_torch.nn.layers import init_weights
    from dispu_tpu_torch.ops.knn import mask_duplicate_rows
    from dispu_tpu_torch.ops.sampling import farthest_point_sample

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    b, n, m = 28, 1024, 256
    gen = torch.Generator(device="cpu").manual_seed(20)
    gt = torch.from_numpy(synthetic_patches(b, n, seed=0)[0]).to(dev)
    sparse = torch.gather(gt, 1, farthest_point_sample(
        m, gt, impl="torch").long()[..., None].expand(-1, -1, 3))
    gnet = DisPUGenerator(GeneratorConfig(), seed=0).to(dev)
    with torch.no_grad():
        backbone = gnet.feature_extraction_coarse(sparse)  # (b, m, 480)
    c_up = backbone.shape[-1]
    refine_c = gnet.PointShuffle.skip.dense.in_features - 6
    feats = (0.5 * torch.randn(b, n, refine_c, generator=gen)).to(dev)
    noise = torch.randn(b, m, ex.NOISE_CHANNELS, generator=gen).to(dev)
    pred = (gt + 0.01 * torch.randn(gt.shape, generator=gen).to(dev))
    gt2 = torch.from_numpy(synthetic_patches(b, n, seed=1)[0]).to(dev)
    del gnet
    counts, lines = {}, []
    zero = dict.fromkeys(kernels.LAUNCHES, 0)

    def hold(label, run, want_counts):
        """``run(impl)`` under the tape: the launches, the selections, the
        plain run on them.  Returns (kernel output, plain output, the
        selections' summary)."""
        nonlocal counts
        tape = SelectionTape()
        kernels.reset_launch_counts()
        with tape.recording():
            out = run("auto")
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        want = dict(zero, **want_counts)
        require(got == want, f"nets_21b {label}: launches {got} != {want}")
        counts = add_counts(counts, got)
        sel = hold_selections(f"nets_21b {label}", tape)
        kernels.reset_launch_counts()
        with tape.replaying(), torch.no_grad():
            plain = run("torch")
        require(kernels.launch_counts() == zero,
                f"nets_21b {label}: the plain run launched a kernel")
        return out, plain, got, sel

    def relative(label, out, plain, kind):
        out = torch.as_tensor(out).detach()
        plain = torch.as_tensor(plain)
        require(bool(torch.isfinite(out).all()),
                f"nets_21b {label}: a non-finite output")
        rel = float((out - plain).abs().max()
                    / plain.abs().max().clamp_min(1e-30))
        require(rel <= NETS_B_REL[kind], f"nets_21b {label}: kernels vs "
                f"plain {rel} (limit {NETS_B_REL[kind]})")
        return rel

    def drive(label, module, inputs, want_counts, kind="exact", pick=1,
              **kw):
        """``pick``: the output of a tuple that is held (the features
        after a downscaler's xyz, a dense block's before its indices)."""
        init_weights(module, torch.Generator().manual_seed(0))
        module = module.to(dev).eval()

        def run(impl):
            out = set_impl(module, impl)(*inputs, **kw)
            return out[pick] if isinstance(out, tuple) else out

        out, plain, got, sel = hold(label, run, want_counts)
        rel = relative(label, out, plain, kind)
        module.zero_grad(set_to_none=True)
        set_impl(module, "auto")
        torch.sum(out.float() ** 2).backward()
        bad = [name for name, p in module.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        require(not bad, f"nets_21b {label}: no finite gradient at {bad}")
        lines.append(
            f"{label}: out {tuple(out.shape)}, launches "
            f"{ {k: v for k, v in got.items() if v} }, selections (calls, "
            f"differing) {sel}, kernels vs plain on the kernels' selections "
            f"{rel:.2e} of the largest (limit {NETS_B_REL[kind]:.0e}), "
            f"backward: {sum(1 for _ in module.parameters())} parameters "
            "with finite gradients")

    def drive_loss(label, fn, want_counts, backward=True):
        leaf = pred.clone().requires_grad_(backward)
        out, plain, got, sel = hold(label, lambda impl: fn(leaf, impl),
                                    want_counts)
        rel = relative(label, out, plain, "exact")
        grad = ""
        if backward:
            (g,) = torch.autograd.grad(out, leaf)
            require(bool(torch.isfinite(g).all()),
                    f"nets_21b {label}: a non-finite gradient")
            grad = f", gradient finite (max |g| {float(g.abs().max()):.3e})"
        value = float(torch.as_tensor(out).detach())
        lines.append(f"{label}: {value:.6e}, launches "
                     f"{ {k: v for k, v in got.items() if v} }, selections "
                     f"(calls, differing) {sel}, kernels vs plain on the "
                     f"kernels' selections {rel:.2e}{grad}")

    # the downscalers: b x n patches, the refiner's feature width
    asnl = dict(npoint=m, nsample=16, mlp=(64, 64, 128))
    drive("PointASNLSetAbstraction", ex.PointASNLSetAbstraction(
        refine_c, **asnl, in_points=n), [gt, feats],
        dict(fps=1, knn=1, attention=1), "attention")
    drive("PointASNLSetAbstraction(use_knn=False)",
          ex.PointASNLSetAbstraction(refine_c, **asnl, in_points=n,
                                     use_knn=False),
          [gt, feats], dict(fps=1, query_ball=1, attention=1), "attention")
    drive("PointDownscale", ex.PointDownscale(refine_c, m, 16),
          [gt, feats], dict(fps=1, knn=1))
    drive("PointDownscale2", ex.PointDownscale2(refine_c, m, 16),
          [gt, feats], dict(fps=1, knn=1))
    drive("PointDownscale3(use_noise=True)", ex.PointDownscale3(
        refine_c, m, 16, use_noise=True), [gt, feats], dict(fps=1, knn=1),
        noise=noise)
    drive("PointDownscale3(use_knn=False)", ex.PointDownscale3(
        refine_c, m, 16, use_knn=False), [gt, feats],
        dict(fps=1, query_ball=1))
    drive("PointDownscale3_1", ex.PointDownscale3_1(refine_c, **asnl),
          [gt, feats], dict(fps=1, knn=1, attention=1), "attention")
    drive("PointDownscale4(use_noise=True)", ex.PointDownscale4(
        refine_c, m, use_noise=True), [gt, feats], dict(fps=1, knn=1),
        noise=noise)
    drive("PointShuffleV1", ex.PointShuffleV1(refine_c, 8), [gt, feats],
          dict(knn=1))
    # the up/shuffle family: the backbone's 480 channels of b x m
    for variant in (1, 2):
        drive(f"UpShuffleLayer(variant={variant})",
              ex.UpShuffleLayer(c_up, variant=variant), [backbone], {})
    drive("UpShuffleLayer3", ex.UpShuffleLayer3(c_up), [backbone],
          dict(knn=1))
    drive("UpShuffleLayer4", ex.UpShuffleLayer4(c_up), [backbone],
          dict(knn=1))
    drive("UpShuffleLayer5", ex.UpShuffleLayer5(c_up), [sparse, backbone],
          dict(knn=1))
    drive("DuplicateUpEdge", ex.DuplicateUpEdge(c_up), [backbone],
          dict(knn=2))
    drive("DuplicateUp2", ex.DuplicateUp2(c_up), [backbone], {})
    drive(f"PointUpscale(npoint={n})", ex.PointUpscale(c_up, n, m),
          [backbone], dict(knn=1))
    drive("WeightLearningUnit", ex.WeightLearningUnit(c_up),
          [backbone[:, :, None, :]], {})
    drive("CoordinateReconstructionUnit",
          ex.CoordinateReconstructionUnit(c_up), [backbone[:, :, None, :]],
          {})
    for faithful in (False, True):
        drive(f"InstanceNorm(faithful={faithful})",
              ex.InstanceNorm(c_up, faithful=faithful), [backbone], {})
    drive("feature_extraction_up", ex.feature_extraction_up(3), [sparse],
          dict(knn=4))
    drive("feature_extraction_down", ex.feature_extraction_down(3),
          [sparse], {})
    drive("EdgeConv(64)", EdgeConv(c_up, 64), [backbone], dict(knn=1))
    for variant in ("v0", "v2"):
        for dense_impl in ("concat", "split"):
            drive(f"DenseEdgeBlock(variant={variant!r}, "
                  f"dense_impl={dense_impl!r})",
                  DenseEdgeBlock(48, 24, variant=variant,
                                 dense_impl=dense_impl),
                  [backbone[..., :48].contiguous()], dict(knn=1), pick=0)
    # the new losses on a b x n prediction
    drive_loss("repulsion4", lambda p, impl: losses.repulsion4(p, impl=impl),
               dict(query_ball=1))
    for use_knn in (False, True):
        for use_l1 in (False, True):
            drive_loss(f"perulsion_loss(use_knn={use_knn}, use_l1={use_l1})",
                       lambda p, impl, a=use_knn, b=use_l1:
                       losses.perulsion_loss(p, use_knn=a, use_l1=b,
                                             impl=impl),
                       dict(knn=1) if use_knn else dict(query_ball=1))
    drive_loss("cd_loss2", lambda p, impl: losses.cd_loss2(p, gt2, impl=impl),
               dict(knn=2))
    drive_loss("uniform_knn", lambda p, impl: losses.uniform_knn(p, impl),
               dict(knn=1))
    drive_loss("geometric_losses", lambda p, impl: sum(
        losses.geometric_losses(p, gt2)), {})
    for cap in (False, True):
        t0 = time.perf_counter()
        drive_loss(f"uniform_exact(cap_counts={cap})",
                   lambda p, impl, cap=cap: losses.uniform_exact(
                       p, cap_counts=cap, impl=impl), dict(fps=1),
                   backward=False)
        lines[-1] += f" ({time.perf_counter() - t0:.2f} s with its replay)"

    # the new kernel shapes, timed
    def time_knn(label, k, pts, qs, bias=None):
        dk, ik = knn_cuda(k, pts, qs, bias)
        dp, ip = knn_torch(k, pts, qs, bias)
        swaps = _near_tie_swaps(f"nets_21b {label}", ik, ip, pts, qs, bias,
                                KNN_SWAP_RTOL)
        scale = 2.0 * float(torch.amax(torch.sum(pts * pts, -1)))
        err = float((torch.abs(dk - dp) / (torch.abs(dp) + scale)).max())
        require(err <= KNN_DIST_RTOL, f"nets_21b {label}: distances {err}")
        ms = timed_ms(lambda: knn_cuda(k, pts, qs, bias), reps=20)
        plain_ms = timed_ms(lambda: knn_torch(k, pts, qs, bias), reps=5)
        library_ms = timed_ms(lambda: torch.topk(
            torch.cdist(qs, pts) ** 2, k, dim=-1, largest=False), reps=5)
        bb, nn, c = pts.shape
        mm = qs.shape[1]
        bms, by = bound(4 * (bb * nn * c + bb * mm * c + 2 * bb * mm * k)
                        + (0 if bias is None else 4 * bb * nn),
                        bb * mm * nn * (2 * c + 4), F32_FLOPS)
        lines.append(f"knn {label} (b={bb} n={nn} m={mm} c={c} k={k}): swaps "
                     f"{swaps}, distances {err:.2e} of the scale, kernel "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cdist+topk "
                     f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by})")

    def dup_bias(x):
        return mask_duplicate_rows(x).float() * 1e30

    tiled = torch.cat([backbone.repeat(1, 4, 1), torch.repeat_interleave(
        torch.tensor([[-0.2, -0.2], [0.2, -0.2], [-0.2, 0.2], [0.2, 0.2]],
                     device=dev), m, dim=0).expand(b, -1, -1)], -1)
    x256 = torch.relu(torch.randn(b, n, 256, generator=gen)).to(dev)
    seeds = sparse.contiguous()
    for label, k, pts, qs, bias in (
            ("DuplicateUpEdge graph 1 (c 482)", 17, tiled, tiled,
             dup_bias(tiled)),
            ("DuplicateUpEdge graph 2 (c 256)", 17, x256, x256,
             dup_bias(x256)),
            ("the backbone's features (c 480)", 17, backbone, backbone,
             dup_bias(backbone)),
            ("the seeds' grouping (k 16)", 16, gt, seeds, None),
            ("PointDownscale4's grouping (k 32)", 32, gt, seeds, None),
            ("PointShuffleV1 / perulsion (self, k 16)", 16, gt, gt, None),
            ("uniform_knn (self, k 6)", 6, gt, gt, None)):
        time_knn(label, k, pts.contiguous(), qs.contiguous(), bias)
    # the non-local cell's map: m queries on n points, bottleneck 64
    bc = max(32, refine_c // 2)
    q = torch.randn(b, m, bc, generator=gen).to(dev)
    kk, v = (torch.randn(b, n, bc, generator=gen).to(dev)
             for _ in range(2))
    sc = 1.0 / math.sqrt(bc)
    err = torch.abs(attention_cuda(q, kk, v, sc)
                    - attention_torch(q, kk, v, sc, bf16_operands=True))
    require(float(err.max()) <= ATTN_MAX_ABS
            and float(err.mean()) <= ATTN_MEAN_ABS,
            f"nets_21b attention: max|d| {float(err.max())}")
    ms = timed_ms(lambda: attention_cuda(q, kk, v, sc), reps=20)
    plain_ms = timed_ms(lambda: attention_torch(q, kk, v, sc,
                                                bf16_operands=True), reps=5)
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        q, kk, v, scale=sc), reps=5)
    bms, by = bound(4 * b * (2 * m * bc + 2 * n * bc),
                    2 * b * m * n * 2 * bc, BF16_FLOPS)
    lines.append(f"attention (b={b} nq={m} nk={n} c=cv={bc}): max|d| "
                 f"{float(err.max()):.3e}, kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
                 f"{bms:.5f} ms ({by})")
    # the seeds: FPS n -> m and the uniform_exact metric's n -> 5%
    for npoint in (m, int(n * 0.05)):
        got = fps_cuda(npoint, gt)
        require(torch.equal(got, fps_torch(npoint, gt)),
                f"nets_21b fps {npoint}: seeds differ")
        ms = timed_ms(lambda: fps_cuda(npoint, gt), reps=20)
        plain_ms = timed_once(lambda: fps_torch(npoint, gt))[1]
        bms, by = bound(4 * b * n * 3 + 4 * b * npoint,
                        b * n * npoint * 9, F32_FLOPS)
        lines.append(f"fps (b={b} n={n} npoint={npoint}): seeds bit-equal, "
                     f"kernel {ms:.4f} ms ({1e3 * ms / npoint:.3f} us a "
                     f"round), plain {plain_ms:.3f} ms, bound {bms:.5f} ms "
                     f"({by})")
    # the ball queries: the downscalers' r 0.2 ns 16 (m of n), the
    # repulsion losses' r 0.07 at ns 20 and 15 (n of n)
    for r, ns, qs in ((0.2, 16, seeds), (0.07, 20, gt), (0.07, 15, gt)):
        qs = qs.contiguous()
        got = query_ball_cuda(r, ns, gt, qs)
        want = query_ball_torch(r, ns, gt, qs)
        rows = _ball_contract("nets_21b ball", got, want, r, gt, qs)
        ms = timed_ms(lambda: query_ball_cuda(r, ns, gt, qs), reps=20)
        plain_ms = timed_ms(lambda: query_ball_torch(r, ns, gt, qs), reps=5)
        c, mq = gt.shape[-1], qs.shape[1]
        full = want[1] == ns
        scanned = torch.where(full, want[0][..., -1].long() + 1, n)
        bms, by = bound(4 * (b * n * c + b * mq * c + b * mq * ns + b * mq),
                        float(scanned.sum()) * (3 * c + 3), F32_FLOPS)
        lines.append(f"query_ball (b={b} n={n} m={mq} r={r} ns={ns}): "
                     f"differing rows {rows}, mean hits "
                     f"{float(want[1].float().mean()):.2f}, kernel "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                     f"{bms:.5f} ms ({by})")
    for line in lines:
        log(f"nets_21b {line}")
    log(f"nets_21b: {time.perf_counter() - t_phase:.1f} s on {card}")
    return counts


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="in phase 4, break one request (exact, turbo, "
                             "each fused refiner setting) and one train "
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

    # phase 3, each check's wall seconds logged
    checks = {"knn": check_knn, "knn_split": check_knn_split,
              "knn_packed": check_knn_packed, "knn_group": check_knn_group,
              "fps": check_fps, "fps_chunked": check_fps_chunked,
              "fps_bucketed": check_fps_bucketed,
              "attention": check_attention,
              "attention_bf16": check_attention_bf16,
              "query_ball": check_query_ball, "fps_lite": check_fps_lite,
              "gather_rows": check_gather_rows,
              "scatter_rows": check_scatter_rows,
              "refine_local": check_refine_local,
              "refine_block": check_refine_block,
              "knn_group_backward": check_knn_group_backward}
    aggs, check_s = {}, {}
    for name, check in checks.items():
        t0 = time.perf_counter()
        aggs[name] = check(dev)
        check_s[name] = time.perf_counter() - t0
    log("phase 3: " + ", ".join(f"{name} {s:.1f} s"
                                for name, s in check_s.items()))
    from dispu_tpu_torch.kernels.measure import KNN_CASES

    train_knn = {case.label: (case.per_step, TRAIN_KNN_MS[case.label])
                 for case in KNN_CASES if case.per_step}
    log(f"kernel ms per train step, by the phase-3 timings: knn "
        f"{sum(times * ms for times, ms in train_knn.values()):.4f} ("
        + ", ".join(f"{label} {times} x {ms:.4f}"
                    for label, (times, ms) in train_knn.items()) + "), "
        f"attention forward {aggs['attention']['train_fwd_ms']:.4f} + "
        f"backward {aggs['attention']['train_bwd_ms']:.4f}, query_ball "
        f"{aggs['query_ball']['ms']:.4f}")
    # phase 4: each path with its own counts; the JSON line sums them
    counts = add_counts(serve(card), serve_16x(card))
    counts = add_counts(counts, serve_stream(card))
    counts = add_counts(counts, serve_turbo(card))
    counts = add_counts(counts, serve_refine(card))
    counts = add_counts(counts, serve_large(card))
    counts = add_counts(counts, serve_export(card))
    counts = add_counts(counts, serve_export_mesh(card))
    counts = add_counts(counts, serve_bf16(card))
    counts = add_counts(counts, train_phase(card, args.profile))
    train_dir = os.path.join(REPO, "chiprun_out", "train_smoke")
    cli_phase(card, train_dir)
    counts = add_counts(counts, cli_phase(card, train_dir, (), "cli_export",
                                          "export"))
    gan_counts, gan_dir = gan_phase(card, args.profile)
    counts = add_counts(counts, gan_counts)
    cli_phase(card, gan_dir, ("--use_gan", "true"), "cli_gan_smoke")
    counts = add_counts(counts, train_bf16(card))
    counts = add_counts(counts, train_turbo(card))
    counts = add_counts(counts, train_remat(card))
    counts = add_counts(counts, evaluate_phase(card))
    counts = add_counts(counts, multi_device(card))
    counts = add_counts(counts, train_utilities(card))
    counts = add_counts(counts, ops_21(card))
    counts = add_counts(counts, nets_21(card))
    counts = add_counts(counts, nets_21b(card))
    if args.profile:
        import dataclasses

        from dispu_tpu_torch import InferenceConfig
        from dispu_tpu_torch.inference import PatchUpsampler

        from dispu_tpu_torch import GeneratorConfig

        turbo = turbo_config()
        for ratio in (4, 16):
            for gen_cfg, inf in (
                    (None, InferenceConfig(final_ratio=ratio)),
                    (turbo.generator, dataclasses.replace(
                        turbo.inference, final_ratio=ratio)),
                    (GeneratorConfig(refine_local_impl="fused"),
                     InferenceConfig(final_ratio=ratio)),
                    (GeneratorConfig(refine_local_impl="megafused"),
                     InferenceConfig(final_ratio=ratio))):
                kw = {} if gen_cfg is None else dict(gen_cfg=gen_cfg)
                profile_request(PatchUpsampler(seed=0, inf_cfg=inf, **kw),
                                load_cloud("Icosahedron.xyz"))

    # phase 5: ms, plain_ms, bound_ms and library_ms are per 2048-point
    # request: a 4x request for knn, fps and attention (attention_bf16: a
    # bf16 4x request's pass, 32 x 1024 x 1024), a 16x request for
    # fps_chunked (its one launch there), a 4x request on a 60,000-point
    # cloud for knn_split (the patch cut); a 4x turbo request for knn_group
    # and fps_bucketed, a 16x turbo request for knn_packed (its one launch
    # there); per train step for query_ball, and for gather_rows and
    # scatter_rows with gather_impl='pallas' (five launches each;
    # gather_rows also with the profiler's device time, see its check); the
    # critic's seed FPS (28 x 1024 -> 128) for fps_lite, which no path
    # calls; a 4x request with refine_local_impl 'fused' / 'megafused' for
    # refine_local / refine_block (one launch at the pass-1 shape;
    # refine_block's ms with knn.cu's launch of its selection before it)
    meta = {
        "knn": ("dispu_tpu_torch/kernels/csrc/knn.cu",
                "dispu_tpu/ops/pallas_kernels.py:867"),
        "knn_split": ("dispu_tpu_torch/kernels/csrc/knn.cu",
                      "dispu_tpu/ops/pallas_kernels.py:867 (past its "
                      "gate, XLA's top_k: dispu_tpu/ops/knn.py:83)"),
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
        "attention_bf16": ("dispu_tpu_torch/kernels/csrc/attention.cu",
                           "dispu_tpu/ops/pallas_kernels.py:2221 (bf16 "
                           "operands as they come, :2237-2240)"),
        "query_ball": ("dispu_tpu_torch/kernels/csrc/query_ball.cu",
                       "dispu_tpu/ops/pallas_kernels.py:1098"),
        "fps_lite": ("dispu_tpu_torch/kernels/csrc/fps.cu",
                     "dispu_tpu/ops/pallas_kernels.py:211"),
        "gather_rows": ("dispu_tpu_torch/kernels/csrc/gather_rows.cu",
                        "dispu_tpu/ops/pallas_kernels.py:1265"),
        "scatter_rows": ("dispu_tpu_torch/kernels/csrc/gather_rows.cu",
                         "dispu_tpu/ops/pallas_kernels.py:1365"),
        "refine_local": ("dispu_tpu_torch/kernels/csrc/refine_local.cu",
                         "dispu_tpu/ops/pallas_kernels.py:2447"),
        "refine_block": ("dispu_tpu_torch/kernels/csrc/refine_block.cu",
                         "dispu_tpu/ops/pallas_kernels.py:2621"),
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
            **{key: a[key] for key in ("device_ms", "library_device_ms")
               if key in a},
        })
    log(json.dumps({"kernels": line}))
    # phase 6
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
