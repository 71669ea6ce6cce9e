#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on an NVIDIA GPU.

    python3 chip_smoke.py            # the whole run, one card
    python3 chip_smoke.py --profile  # and where one request's time goes

Phases, each of which fails the run (non-zero exit) when it fails:
  1. the card's name and power limit (nvidia-smi) and the CUDA version;
  2. build every kernel from ``dispu_tpu_torch/kernels/csrc`` with nvcc,
     all sources at once, into ``dispu_tpu_torch/_build/``;
  3. hold each kernel against its plain PyTorch version on the card, at
     the shapes of the serving path of a 2048-point cloud, and time the
     kernel, the plain version and one PyTorch library call for the same
     function where there is one;
  4. serve 6 whole-cloud 4x requests at full GeneratorConfig() width
     (demo/gt/Icosahedron.xyz and demo/gt/fandisk.xyz, 3 times each) from
     the port's own seeded init, with the launch counts set to 0 just
     before and read just after, and compare the output with the same
     path run through the plain versions (impl='torch') on the card;
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
# the whole path through the kernels vs through the plain versions
# generator 'fine' output per chunk, in patch units: rows agree to f32
# round-off except where a kNN near-tie (distances within ~1e-6) falls on
# the k-th place and the two paths keep different neighbours.  Readings on
# an H100 at 700 W: rows within 1e-4 0.99997, max |d| 5.4e-4, Chamfer
# 2.8e-8 and 7.6e-9; each limit leaves one to two orders of headroom.
GEN_ROW_ABS = 1e-4         # a row (point) within this counts as agreeing
GEN_ROW_FRAC = 0.99        # share of rows of each chunk that must agree
GEN_MAX_ABS = 1e-2         # no row beyond this
CHAMFER_MAX = 1e-6         # symmetric Chamfer of the outputs (cloud units²)


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


def load_cloud(name: str):
    import numpy as np

    path = os.path.join(REPO, "demo", "gt", name)
    return np.loadtxt(path, dtype=np.float32)[:, :3]


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

    # (label, points, queries, k, duplicate bias, launches per request)
    cases = [
        ("patch k256", cloud[None], cloud[None, ::85][:, :24], 256, False, 1),
        ("backbone c24", feats(32, 256, 24, 8), None, 17, True, 1),
        ("backbone c48", feats(32, 256, 48, 8), None, 17, True, 3),
        ("refiner", feats(32, 1024, 3, 0), None, 16, False, 1),
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
            return torch.topk(d, k, dim=-1, largest=False)

        library_ms = timed_ms(library, reps=5)
        nbytes = 4 * (b * n * c + b * m * c + (b * n if dup else 0)) \
            + 8 * b * m * k
        ops = b * m * n * (2 * c + 4)
        bms, by = bound(nbytes, ops, F32_FLOPS)
        log(f"knn {label:13s} (b={b} n={n} m={m} c={c} k={k}): "
            f"max|d|err {max_abs:.3e} rel {float(dist_err.max()):.2e}, "
            f"swaps {n_swaps}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"cdist+topk {library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
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
    # (label, xyz, npoint, launches per request); the last case takes the
    # device-scratch path (n > 32768), which the serving path at 2048
    # points does not reach
    cases = [("seeds", cloud[None], 24, 1), ("merge", merged, 8192, 1),
             ("scratch n=120000", torch.randn(2, 120000, 3, generator=gen),
              256, 0)]
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
        if not per_req:
            log(f"fps {label}: (b={b} n={n} -> {npoint}) bit-equal")
            continue
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


def check_attention(dev):
    import torch
    import torch.nn.functional as F

    from dispu_tpu_torch.kernels.attention import (attention_cuda,
                                                   attention_torch)

    gen = torch.Generator(device="cpu").manual_seed(3)
    b, n, c = 32, 1024, 64
    scale = 1.0 / math.sqrt(c)
    q, k, v = (torch.randn(b, n, c, generator=gen).to(dev) for _ in range(3))
    got = attention_cuda(q, k, v, scale)
    want = attention_torch(q, k, v, scale, bf16_operands=True)
    f32 = attention_torch(q, k, v, scale)
    torch.cuda.synchronize()
    err = torch.abs(got - want)
    max_abs, mean_abs = float(err.max()), float(err.mean())
    dev_f32 = float(torch.abs(got - f32).max())
    require(max_abs <= ATTN_MAX_ABS and mean_abs <= ATTN_MEAN_ABS,
            f"attention: max|d| {max_abs}, mean {mean_abs}")
    ms = timed_ms(lambda: attention_cuda(q, k, v, scale), reps=10)
    plain_ms = timed_ms(
        lambda: attention_torch(q, k, v, scale, bf16_operands=True), reps=5)
    library_ms = timed_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps=5)
    nbytes = 4 * (3 * b * n * c + b * n * c)
    ops = 2 * b * n * n * (c + c)
    bms, by = bound(nbytes, ops, BF16_FLOPS)
    # the widest instantiation (cv > 128), which fine_extractor=True reaches
    # at c = cv = 184; checked here, timed nowhere
    qw, kw, vw = (torch.randn(4, n, 184, generator=gen).to(dev)
                  for _ in range(3))
    wide = float(torch.abs(
        attention_cuda(qw, kw, vw, 184 ** -0.5)
        - attention_torch(qw, kw, vw, 184 ** -0.5, bf16_operands=True)).max())
    require(wide <= ATTN_MAX_ABS, f"attention c=cv=184: max|d| {wide}")
    log(f"attention (b=4 nq=nk={n} c=cv=184): max|d| {wide:.3e} "
        f"(bound {ATTN_MAX_ABS})")
    log(f"attention (b={b} nq=nk={n} c=cv={c}): max|d| {max_abs:.3e} "
        f"(bound {ATTN_MAX_ABS}), mean {mean_abs:.3e}, vs f32 plain "
        f"{dev_f32:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bms, t_bytes=nbytes / HBM_BYTES_PER_S,
                t_ops=ops / BF16_FLOPS, max_abs_err=max_abs)


# --------------------------------------------------------------- phase 4


def serve(card: str):
    import numpy as np
    import torch

    from dispu_tpu_torch import kernels
    from dispu_tpu_torch.inference import PatchUpsampler, plan_counts
    from dispu_tpu_torch.ops.geometry import normalize_point_cloud

    up = PatchUpsampler(device="cuda", seed=0)
    clouds = {name: load_cloud(name)
              for name in ("Icosahedron.xyz", "fandisk.xyz")}
    expected = dict(knn=0, fps=0, attention=0)
    for pc in clouds.values():
        seed_num, _ = plan_counts(pc.shape[0], up.inf_cfg)
        chunks = -(-seed_num // up.inf_cfg.patch_batch)
        expected["fps"] += 3 * 2
        expected["knn"] += 3 * (1 + 5 * chunks)
        expected["attention"] += 3 * chunks

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
    log(f"launches over 6 requests: {counts} (expected {expected})")
    require(counts == expected, f"launch counts {counts} != {expected}")

    ref = PatchUpsampler(device="cuda", seed=0, impl="torch")
    max_gen, max_cd = 0.0, 0.0
    with torch.inference_mode():
        for name, pc in clouds.items():
            out_ref = ref.upsample(pc)
            a = torch.from_numpy(outs[name]).cuda()
            r = torch.from_numpy(out_ref).cuda()
            d = torch.cdist(a, r) ** 2
            cd = float(d.min(1).values.mean() + d.min(0).values.mean())
            pc_n, _, _ = normalize_point_cloud(torch.from_numpy(pc).cuda())
            seed_num, _ = plan_counts(pc.shape[0], up.inf_cfg)
            patches, _, _, seeds = up.prepare(pc_n, seed_num)
            _, _, _, seeds_ref = ref.prepare(pc_n, seed_num)
            require(torch.equal(seeds, seeds_ref), f"{name}: seeds differ")
            gen_err, agree = [], []
            for chunk in up.chunks(patches):
                row = torch.abs(up.model(chunk)[1]
                                - ref.model(chunk)[1]).amax(dim=-1)
                gen_err.append(float(row.max()))
                agree.append(float((row <= GEN_ROW_ABS).float().mean()))
            log(f"{name}: kernels vs plain path on the card: Chamfer "
                f"{cd:.3e} (bound {CHAMFER_MAX}); generator per chunk: "
                f"max|d| {['%.3e' % e for e in gen_err]} (bound "
                f"{GEN_MAX_ABS}), rows within {GEN_ROW_ABS} "
                f"{['%.5f' % a for a in agree]} (bound {GEN_ROW_FRAC})")
            require(min(agree) >= GEN_ROW_FRAC, f"{name}: rows agree {agree}")
            max_gen, max_cd = max(max_gen, *gen_err), max(max_cd, cd)
    require(max_gen <= GEN_MAX_ABS, f"generator deviation {max_gen}")
    require(max_cd <= CHAMFER_MAX, f"Chamfer {max_cd}")

    warm = [t for ts in times.values() for t in ts[1:]]
    log(f"ms per 2048-point 4x request after warm-up: mean "
        f"{sum(warm) / len(warm):.2f} ({', '.join('%.2f' % t for t in warm)};"
        f" first requests {[round(ts[0], 2) for ts in times.values()]}) "
        f"on {card}")
    return counts


def profile_request(up, pc):
    """Where one warm request's time goes: host-clock stage times around
    synchronized stages, then a torch.profiler trace of one request with
    device time summed by kernel name and the device's busy share."""
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

    with torch.inference_mode():
        up.upsample(pc)  # warm
        pc_n, _, _ = stage("normalize", lambda: normalize_point_cloud(
            torch.from_numpy(pc).cuda()))
        patches, cen, fur, _ = stage(
            "prepare: seed FPS, patch kNN", lambda: up.prepare(pc_n,
                                                               seed_num))
        pred = stage("generate: 1 chunk of 32 patches",
                     lambda: up.generate(patches) * fur + cen)
        stage("merge FPS", lambda: up.merge(pred.reshape(-1, 3), out_num))
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
                        help="after phase 4, break one request down by "
                             "stage and by device kernel")
    args = parser.parse_args()

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
            "attention": check_attention(dev)}
    # phase 4
    counts = serve(card)
    if args.profile:
        from dispu_tpu_torch.inference import PatchUpsampler

        profile_request(
            PatchUpsampler(device="cuda", seed=0),
            load_cloud("Icosahedron.xyz"))

    # phase 5
    meta = {
        "knn": ("dispu_tpu_torch/kernels/csrc/knn.cu",
                "dispu_tpu/ops/pallas_kernels.py:867"),
        "fps": ("dispu_tpu_torch/kernels/csrc/fps.cu",
                "dispu_tpu/ops/pallas_kernels.py:87"),
        "attention": ("dispu_tpu_torch/kernels/csrc/attention.cu",
                      "dispu_tpu/ops/pallas_kernels.py:2221"),
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
