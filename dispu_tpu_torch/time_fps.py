"""Time the FPS route, a kernel or a whole request of one or more
checkouts on the card, in turns.

    python3 -m dispu_tpu_torch.time_fps [--b 1] [--n 98304] [--npoint 32768]
                                        [--reps 3]
                                        [--kernel KERNEL | --request R
                                         [--points N [--exact]] | --steps]
                                        [TREE ...]

Each TREE is the root of a checkout of this repository (default: the one
this module lies in).  Every tree's own code runs in a process of its own
on the same input, first in the order given and then in reverse (a, b, b,
a).  Prints the card's name and power limit, then one JSON line a run with
the mean milliseconds a call and a digest of the output, which must agree
between trees that compute the same function.  Two trees are compared
only within one such call.

- Default (``--kernel route``): ``ops.sampling.farthest_point_sample`` on
  ``torch.randn(b, n, 3)`` from seed 0, with the first 100 points copied
  to the end so that tied distances occur, timed with CUDA events after
  one warm-up call.  ``--kernel fps`` or ``--kernel fps_chunked`` times
  that kernel's wrapper instead, at any n it takes.  This is how the
  device-scratch form of ``fps.cu``, which the cluster kernel
  ``fps_chunked.cu`` replaced at the 16× merge shape, was timed: on a
  checkout of the commit before the replacement; and so were the forms of
  ``fps_chunked.cu``, each in a checkout whose list of forms
  (``with_form``) held only it.
- ``--kernel gather_rows``: ``gather_rows_cuda`` and, beside it,
  ``torch.gather`` at the train step's three gather shapes
  (``measure.GATHER_CASES``, b = 28, loaded from this checkout into every
  tree): ``ms`` by CUDA events around ``--reps`` back-to-back calls (at
  the small widths that is the host's time a call), ``kernel_ms`` the
  device time of their kernels in a ``torch.profiler`` trace
  (``measure.device_ms``), a call each; the top-level numbers are a train
  step's aggregate (1 × c 24, 3 × c 48, 1 × c 131), ``shapes`` each
  shape's.
- ``--kernel scatter_rows``: ``scatter_rows_cuda`` at every shape of
  ``measure.SCATTER_CASES`` (inputs from ``measure.scatter_inputs`` with
  seed 10): ``ms`` by CUDA events around ``--reps`` back-to-back calls,
  ``kernel_ms`` the profiler's device time a call, ``kernels`` the same
  by kernel name (each pass of the index build and the sum), ``syncs``
  the ``cudaStreamSynchronize`` and ``cudaMemcpy*`` calls in the
  profiler's CPU trace of one call, and a digest a shape; the top-level
  numbers are a ``gather_impl='pallas'`` step's five launches, and
  ``fused_`` ones a ``fused_grouping`` step's six.
- ``--kernel fps_bucketed``: ``fps_bucketed_cuda`` at every shape of
  ``measure.BUCKETED_CASES`` (inputs from ``measure.bucketed_inputs``
  with seed 7): ``ms`` by CUDA events, ``kernel_ms`` the profiler's
  device time, ``us_round`` the latter over the m_b − 1 rounds, and a
  digest a shape; the top-level ``ms`` is the 4× merge's.  To time a
  form, copy the package into ``_trees/NAME/`` with the list in
  ``csrc/fps_bucketed.cu``'s ``with_form`` edited and pass that tree too.
- ``--kernel knn``: ``knn_kernel_cuda`` (the shape gate) at every shape
  of ``measure.KNN_CASES`` and ``measure.KNN_WIDE_CASES`` (inputs from
  ``measure.knn_inputs`` with seed 1, the patch cuts on the normalized
  ``demo/gt/Icosahedron.xyz`` and on a 60,000-point scan, ``measure``
  loaded from this checkout into every tree), ``ms`` by CUDA events
  around ``--reps`` back-to-back calls after one warm-up, ``kernel_ms``
  the profiler's device time a call (``measure.device_ms``), and a digest
  of (dists, idx) a shape; the top-level ``ms`` is a 4× request's
  launches.
  ``--kernel knn_group``: ``knn_group_cuda`` the same way at
  ``measure.KNN_GROUP_CASES`` (seed 5), its digest over (dists, idx,
  grouped xyz, grouped features); the top-level ``ms`` is a 4× turbo
  request's.  Equal digests at every shape say the two trees' kernels
  return the same bits.
- ``--kernel refine_local`` / ``--kernel refine_block``: that kernel at
  every shape of ``measure.REFINE_CASES`` (the refiner's pass 1 and
  pass 2, and pass 2 at ``patch_num_point`` 512, at ``GeneratorConfig()``
  width; parameters from
  ``measure.refine_params`` with seed 12, then grouped rows, or points
  and features, from the same generator), ``ms`` by CUDA events around
  ``--reps`` back-to-back calls after one warm-up, ``chain_ms`` the same
  for the cuBLAS chain ``measure.refine_chain`` (for ``refine_block``
  after ``cdist`` + ``topk`` + the gather), and ``err``, max |kernel −
  plain version| over max(max |plain|, 1); no digest of the output,
  since the trees sum in different orders by design, but for
  ``refine_block`` one of its selection (``idx_digest``) and the
  profiler's device ms by kernel name (``kernels``: ``knn.cu``'s
  selection and the block, where they are two launches).  The top-level
  ``ms`` is a 16× request's launches (``per_16x``).  A shape the tree's
  kernel refuses (``ValueError``: ``refine_block`` past 5,195 points
  where its selection keeps distance rows in shared memory) is written
  ``refused``.
- ``--kernel query_ball``: ``query_ball_cuda`` at every shape of
  ``measure.BALL_CASES`` (inputs from ``measure.ball_inputs`` with seed
  4, the radius a Python float) and at three edges (nsample 1, nsample
  128 with select 100, a ball empty for every query), ``ms`` by CUDA
  events around ``--reps`` back-to-back calls in the select mode the
  losses run, ``kernel_ms`` the profiler's device time, ``syncs`` the
  ``cudaStreamSynchronize`` and ``cudaMemcpy*`` calls in the profiler's
  CPU trace of one call, and a digest over all three output modes; the
  top-level ``ms`` and ``kernel_ms`` are a CD step's, ``gan_ms`` and
  ``gan_kernel_ms`` a GAN step's.
- ``--kernel knn_packed``: ``knn_packed_cuda`` on ``chip_smoke.py``'s
  inputs at pass 2's refiner shape of a 16× turbo request (32 × 4096²,
  c 3) at k 16, 1 and 32, past the tiled form (k 33 on two patches of
  1024), with the duplicate bias (c 24, k 17) and with +inf
  on all but 10 columns (k 16), each with a digest; the top-level ``ms``
  is the first, a 16× turbo request's one launch.
- ``--steps``: CD train steps at batch 28 (``ExperimentConfig()``,
  ``make_train_step`` from ``create_generator_state(seed=0)``, one fixed
  batch of ``synthetic_patches`` with seed 0, as ``chip_smoke.py``'s
  training phase), the default step and with ``gather_impl='pallas'``
  (``pallas_``) and ``fused_grouping`` (``fused_``): the median host wall
  ms of ``--reps`` warm steps, each ended by a host fetch of its loss,
  and a digest of every step's loss.
- ``--request R --points N``: the turbo request alone on a scan of N
  points on a torus (``chip_smoke.py``'s ``big_cloud`` with seed 11),
  under ``turbo_``; with ``--exact`` also the exact request
  (``InferenceConfig(final_ratio=R)``) first, under the bare keys.
- ``--request R``: ``PatchUpsampler(seed=0, inf_cfg=InferenceConfig(
  final_ratio=R)).upsample`` of ``demo/gt/fandisk.xyz``, host wall
  milliseconds a call (the result is on the host when it returns) over
  ``--reps`` calls after one warm-up; ``ms_each`` lists every call.  Then
  the same for the turbo configuration of ``python -m dispu_tpu_torch.cli
  --phase test --turbo true`` at ratio R, under ``turbo_ms``,
  ``turbo_ms_each`` and ``turbo_digest``, and for ``refine_local_impl``
  'fused' and 'megafused' under ``fused_`` and ``megafused_``.  With
  ``--patch P`` the exact and 'megafused' requests alone, at
  ``patch_num_point`` P.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

CHILD = r"""
import hashlib, importlib, json, sys, time, torch
b, n, npoint, reps = map(int, sys.argv[1:5])
mode = sys.argv[5]
patch = int(sys.argv[7])


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def event_ms(fn):
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


if mode.startswith("request"):
    import dataclasses
    import numpy as np
    from dispu_tpu_torch import InferenceConfig, cli
    from dispu_tpu_torch.inference import PatchUpsampler
    ratio, _, points = mode[len("request"):].partition("_")
    points, exact = points.rstrip("x"), points.endswith("x")
    ratio = int(ratio)
    turbo = cli.build_config(cli.parse_args(["--phase", "test", "--turbo",
                                             "true"]))
    from dispu_tpu_torch import GeneratorConfig
    setups = [("turbo_", PatchUpsampler(
        seed=0, gen_cfg=turbo.generator, inf_cfg=dataclasses.replace(
            turbo.inference, final_ratio=ratio)))]
    if points:
        # a scan on a torus's surface (chip_smoke.py's big_cloud, seed 11)
        rs = np.random.RandomState(11)
        u, v = rs.uniform(0.0, 2.0 * np.pi, (2, int(points)))
        ring = 1.0 + 0.35 * np.cos(v)
        pc = np.stack([ring * np.cos(u), ring * np.sin(u), 0.35 * np.sin(v)],
                      1)
        pc = (pc + 0.002 * rs.randn(int(points), 3)).astype(np.float32)
        if exact:
            setups = [("", PatchUpsampler(seed=0, inf_cfg=InferenceConfig(
                final_ratio=ratio)))] + setups
    elif patch:
        pc = np.loadtxt("demo/gt/fandisk.xyz", dtype=np.float32)[:, :3]
        inf = InferenceConfig(final_ratio=ratio, patch_num_point=patch)
        setups = [("", PatchUpsampler(seed=0, inf_cfg=inf)), (
            "megafused_", PatchUpsampler(seed=0, gen_cfg=GeneratorConfig(
                refine_local_impl="megafused"), inf_cfg=inf))]
    else:
        pc = np.loadtxt("demo/gt/fandisk.xyz", dtype=np.float32)[:, :3]
        setups = [("", PatchUpsampler(seed=0, inf_cfg=InferenceConfig(
            final_ratio=ratio)))] + setups + [
            (f"{impl}_", PatchUpsampler(
                seed=0, gen_cfg=GeneratorConfig(refine_local_impl=impl),
                inf_cfg=InferenceConfig(final_ratio=ratio)))
            for impl in ("fused", "megafused")]
    result = {}
    for key, up in setups:
        out = up.upsample(pc)
        each = []
        for _ in range(reps):
            t0 = time.perf_counter()
            up.upsample(pc)
            each.append((time.perf_counter() - t0) * 1e3)
        result.update({key + "ms": sum(each) / reps, key + "ms_each": each,
                       key + "digest": digest(out)})
    print(json.dumps(result))
elif mode == "steps":
    import dataclasses
    import statistics
    import numpy as np
    from dispu_tpu_torch.config import ExperimentConfig
    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step
    cfg = ExperimentConfig()
    bs = cfg.train.batch_size
    data = PatchDataset(h5_path="/nonexistent.h5",
                        synthetic_patches_count=3 * bs, seed=0)
    gt = torch.from_numpy(data.gt[:bs]).cuda()
    radius = torch.from_numpy(data.radius[:bs]).cuda()
    result = {}
    for key, kw in (("", {}), ("pallas_", dict(gather_impl="pallas")),
                    ("fused_", dict(fused_grouping=True))):
        c = dataclasses.replace(cfg, generator=dataclasses.replace(
            cfg.generator, **kw))
        st = create_generator_state(c.generator, seed=0, device="cuda")
        step = make_train_step(c)
        gen = torch.Generator(device="cuda").manual_seed(0)
        each, totals = [], []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step(st, gt, radius, gen)
            totals.append(float(m["total"]))  # a host fetch: synchronized
            each.append((time.perf_counter() - t0) * 1e3)
        result.update({key + "ms": statistics.median(each[1:]),
                       key + "ms_each": each[1:],
                       key + "digest": digest(np.array(totals))})
    print(json.dumps(result))
elif mode == "gather_rows":
    import importlib.util
    from dispu_tpu_torch.kernels.gather_rows import gather_rows_cuda
    spec = importlib.util.spec_from_file_location("measure", sys.argv[6])
    measure = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(measure)
    gen = torch.Generator().manual_seed(0)
    shapes, total, outs = {}, {}, []
    for label, n, c, per, launches in measure.GATHER_CASES:
        table, idx = measure.gather_inputs(gen, n, c, per)
        table, idx = table.cuda(), idx.cuda()
        flat = idx.long()[..., None].expand(-1, -1, c)
        outs.append(gather_rows_cuda(table, idx).cpu().numpy())
        shapes[label] = {
            "ms": event_ms(lambda: gather_rows_cuda(table, idx)),
            "kernel_ms": measure.device_ms(
                lambda: gather_rows_cuda(table, idx), reps),
            "torch_gather_ms": event_ms(lambda: torch.gather(table, 1, flat)),
            "torch_gather_kernel_ms": measure.device_ms(
                lambda: torch.gather(table, 1, flat), reps)}
        for key, val in shapes[label].items():
            total[key] = total.get(key, 0.0) + launches * val
    print(json.dumps({**total, "shapes": shapes, "digest": digest(*outs)}))
elif mode in ("scatter_rows", "fps_bucketed"):
    import importlib.util
    import numpy as np
    spec = importlib.util.spec_from_file_location("measure", sys.argv[6])
    measure = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(measure)
    from torch.profiler import ProfilerActivity, profile
    shapes, total = {}, {}
    if mode == "scatter_rows":
        from dispu_tpu_torch.kernels.gather_rows import scatter_rows_cuda
        gen = torch.Generator().manual_seed(10)
        cases = measure.SCATTER_CASES
    else:
        from dispu_tpu_torch.kernels.fps_bucketed import fps_bucketed_cuda
        gen = torch.Generator().manual_seed(7)
        cases = measure.BUCKETED_CASES
    for case in cases:
        if mode == "scatter_rows":
            g, idx = (t.cuda() for t in measure.scatter_inputs(gen, case))
            def call():
                return scatter_rows_cuda(g, idx, case.n)
        else:
            x = measure.bucketed_inputs(gen, case).cuda()
            def call():
                return fps_bucketed_cuda(case.mb, x)
        out = call().cpu().numpy()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        syncs = sum(1 for evt in prof.events()
                    if "Synchronize" in evt.name or "Memcpy" in evt.name)
        one = {"ms": event_ms(call),
               "kernel_ms": measure.device_ms(call, reps),
               "kernels": measure.device_ms_by_kernel(call, reps),
               "syncs": syncs, "digest": digest(out)}
        if mode == "scatter_rows":
            key = "" if case.setting == "pallas" else "fused_"
            for name in ("ms", "kernel_ms"):
                total[key + name] = (total.get(key + name, 0.0)
                                     + case.per_step * one[name])
        else:
            one["us_round"] = one["kernel_ms"] / (case.mb - 1) * 1e3
            if not total:
                total = {"ms": one["ms"], "kernel_ms": one["kernel_ms"]}
        shapes[case.label] = one
    joined = "".join(v["digest"] for v in shapes.values()).encode()
    print(json.dumps({**total, "shapes": shapes,
                      "digest": digest(np.frombuffer(joined, np.uint8))}))
elif mode in ("knn", "knn_group"):
    import importlib.util
    import numpy as np
    spec = importlib.util.spec_from_file_location("measure", sys.argv[6])
    measure = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(measure)
    from dispu_tpu_torch.ops.knn import mask_duplicate_rows
    shapes, total = {}, 0.0
    if mode == "knn":
        from dispu_tpu_torch.kernels.knn import knn_kernel_cuda
        from dispu_tpu_torch.ops.geometry import normalize_point_cloud
        cloud = normalize_point_cloud(torch.from_numpy(np.loadtxt(
            "demo/gt/Icosahedron.xyz", dtype=np.float32)[:, :3]))[0]
        cases = measure.KNN_CASES + measure.KNN_WIDE_CASES
        inputs = measure.knn_inputs(torch.Generator().manual_seed(1), cases,
                                    cloud)
    else:
        from dispu_tpu_torch.kernels.knn_group import knn_group_cuda
        cases = measure.KNN_GROUP_CASES
        inputs = measure.knn_group_inputs(torch.Generator().manual_seed(5),
                                          cases)
    for case, (pts, other) in zip(cases, inputs):
        pts = pts.cuda()
        other = pts if other is None else other.cuda()
        dup = case.dup if mode == "knn" else case.drop_first
        bias = mask_duplicate_rows(pts).float() * 1e30 if dup else None
        if mode == "knn":
            def call():
                return knn_kernel_cuda(case.k, pts, other, bias)
        else:
            def call():
                return knn_group_cuda(case.k, pts, pts, other, bias,
                                      exact=case.exact,
                                      with_xyz=case.with_xyz,
                                      drop_first=case.drop_first)
        out = [o.cpu().numpy() for o in call() if o is not None]
        ms = event_ms(call)
        shapes[case.label] = {"ms": ms, "digest": digest(*out)}
        if mode == "knn":
            shapes[case.label]["kernel_ms"] = measure.device_ms(call, reps)
        total += case.per_request * ms
    joined = "".join(v["digest"] for v in shapes.values()).encode()
    print(json.dumps({"ms": total, "shapes": shapes,
                      "digest": digest(np.frombuffer(joined, np.uint8))}))
elif mode == "query_ball":
    import importlib.util
    import numpy as np
    spec = importlib.util.spec_from_file_location("measure", sys.argv[6])
    measure = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(measure)
    from torch.profiler import ProfilerActivity, profile
    from dispu_tpu_torch.kernels.query_ball import query_ball_cuda
    gen = torch.Generator().manual_seed(7)  # chip_smoke.py's inputs
    edges = [measure.BallCase("nsample 1", 2, 1000, 300, 3, 0.1, 1, 1, 0, 0),
             measure.BallCase("nsample 128", 2, 4096, 64, 3, 0.4, 128, 100,
                              0, 0),
             measure.BallCase("empty", 2, 500, 100, 3, 1e-6, 8, 3, 0, 0)]
    shapes, total = {}, {}
    for case in measure.BALL_CASES + edges:
        pts, qs = (t.cuda() for t in measure.ball_inputs(gen, case))
        if case.label == "empty":
            qs = qs + 0.5  # no point within 1e-6 of any query
        r, ns, s = float(case.radius), case.nsample, case.select
        out = [o.cpu().numpy() for o in query_ball_cuda(r, ns, pts, qs,
                                                        True, s)]
        out += [o.cpu().numpy() for mode in ((), (True,))
                for o in query_ball_cuda(r, ns, pts, qs, *mode)]
        def call():
            return query_ball_cuda(r, ns, pts, qs, False, s)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        syncs = sum(1 for evt in prof.events()
                    if "Synchronize" in evt.name or "Memcpy" in evt.name)
        shapes[case.label] = {"ms": event_ms(call),
                              "kernel_ms": measure.device_ms(call, reps),
                              "syncs": syncs, "digest": digest(*out)}
        for key, per in (("", case.per_cd_step), ("gan_", case.per_gan_step)):
            for name in ("ms", "kernel_ms"):
                total[key + name] = (total.get(key + name, 0.0)
                                     + per * shapes[case.label][name])
    joined = "".join(v["digest"] for v in shapes.values()).encode()
    print(json.dumps({**total, "shapes": shapes,
                      "digest": digest(np.frombuffer(joined, np.uint8))}))
elif mode == "knn_packed":
    import numpy as np
    from dispu_tpu_torch.kernels.knn import knn_packed_cuda
    from dispu_tpu_torch.ops.knn import mask_duplicate_rows
    gen = torch.Generator().manual_seed(6)
    # chip_smoke.py's inputs: pass 2's cloud, its first 1024 points of two
    # patches for k 33; then the duplicate bias and +inf columns
    p2 = torch.randn(32, 4096, 3, generator=gen)
    shapes, total = {}, 0.0
    for label, bb, nn, c, k, extra in (
            ("pass 2 k16", 32, 4096, 3, 16, None), ("k1", 32, 4096, 3, 1, None),
            ("k32", 32, 4096, 3, 32, None), ("k33", 2, 1024, 3, 33, None),
            ("dup c24 k17", 32, 256, 24, 17, "dup"),
            ("inf k16", 4, 1024, 3, 16, "inf")):
        if c == 3 and extra is None:
            pts = p2[:bb, :nn].contiguous()
        else:
            pts = torch.randn(bb, nn, c, generator=gen)
        if extra == "dup":
            pts[:, -8:] = pts[:, :8]
        pts = pts.cuda()
        if extra == "dup":
            bias = mask_duplicate_rows(pts).float() * 1e30
        elif extra == "inf":
            bias = torch.full((bb, nn), float("inf"), device="cuda")
            bias[:, ::100] = 0.0  # 11 finite columns: the rest by index
        else:
            bias = None
        def call():
            return knn_packed_cuda(k, pts, pts, bias)
        out = [o.cpu().numpy() for o in call()]
        shapes[label] = {"ms": event_ms(call), "digest": digest(*out)}
        total += shapes[label]["ms"] if label == "pass 2 k16" else 0.0
    joined = "".join(v["digest"] for v in shapes.values()).encode()
    print(json.dumps({"ms": total, "shapes": shapes,
                      "digest": digest(np.frombuffer(joined, np.uint8))}))
elif mode in ("refine_local", "refine_block"):
    import importlib.util
    spec = importlib.util.spec_from_file_location("measure", sys.argv[6])
    measure = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(measure)
    from dispu_tpu_torch.inference import pin_f32
    from dispu_tpu_torch.kernels import refine_block, refine_local
    pin_f32()
    gen = torch.Generator().manual_seed(12)
    cases = measure.REFINE_CASES
    p = refine_local.LocalParams(*(
        t.cuda() for t in measure.refine_params(gen, cases[0])))
    chain = measure.refine_chain(p)
    shapes, total = {}, 0.0
    for case in cases:
        extra = {}
        if mode == "refine_local":
            g = torch.randn(case.b, case.n, case.k, 6 + case.c,
                            generator=gen).cuda()
            def call():
                return refine_local.refine_local_cuda(g, p)
            def plain():
                return refine_local.refine_local_torch(g, p)
            def lib():
                return chain(g)
        else:
            xyz = torch.randn(case.b, case.n, 3, generator=gen).cuda()
            feats = torch.randn(case.b, case.n, case.c, generator=gen).cuda()
            def call():
                return refine_block.refine_block_cuda(xyz, feats, p)
            def plain():
                _, idx = refine_block.refine_block_cuda(xyz, feats, p,
                                                        with_idx=True)
                extra["idx_digest"] = digest(idx.cpu().numpy())
                return refine_block.refine_block_torch(xyz, feats, p,
                                                       idx=idx)
            def lib():
                sel = torch.topk(torch.cdist(xyz, xyz) ** 2, case.k, dim=-1,
                                 largest=False)[1]
                return chain(refine_block.grouped_rows(xyz, feats, sel))
        try:
            got = call()
        except ValueError as refused:  # a tree whose kernel takes fewer n
            shapes[case.label] = {"refused": str(refused)}
            continue
        want = plain()
        scale = max(float(want.abs().max()), 1.0)
        err = float((got - want).abs().max()) / scale
        if mode == "refine_block":  # the selection's launch and the block's
            extra["kernels"] = measure.device_ms_by_kernel(call, reps)
        shapes[case.label] = {"ms": event_ms(call), "chain_ms": event_ms(lib),
                              "err": err, **extra}
        total += case.per_16x * shapes[case.label]["ms"]
    print(json.dumps({"ms": total, "shapes": shapes}))
else:
    if mode == "route":
        from dispu_tpu_torch.ops.sampling import farthest_point_sample
    else:
        module = importlib.import_module("dispu_tpu_torch.kernels." + mode)
        farthest_point_sample = getattr(module, mode + "_cuda")
    gen = torch.Generator().manual_seed(0)
    xyz = torch.randn(b, n, 3, generator=gen)
    xyz[:, n - 100:] = xyz[:, :100]
    xyz = xyz.cuda()
    out = farthest_point_sample(npoint, xyz)
    ms = event_ms(lambda: farthest_point_sample(npoint, xyz))
    print(json.dumps({"ms": ms, "digest": digest(out.cpu().numpy())}))
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*",
                        default=[str(pathlib.Path(__file__).parents[1])])
    parser.add_argument("--b", type=int, default=1)
    parser.add_argument("--n", type=int, default=98304)
    parser.add_argument("--npoint", type=int, default=32768)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--kernel", default="route",
                        choices=("route", "fps", "fps_chunked",
                                 "fps_bucketed", "gather_rows",
                                 "scatter_rows", "knn", "knn_group",
                                 "knn_packed", "query_ball",
                                 "refine_local", "refine_block"))
    parser.add_argument("--request", type=int, default=None, metavar="R",
                        help="time whole upsample requests at final "
                             "ratio R instead of a kernel")
    parser.add_argument("--points", type=int, default=0,
                        help="with --request: a turbo request on a scan of "
                             "this many points instead of demo/gt/fandisk.xyz")
    parser.add_argument("--exact", action="store_true",
                        help="with --points: time the exact request too")
    parser.add_argument("--patch", type=int, default=0,
                        help="with --request: the exact and 'megafused' "
                             "requests alone at this patch_num_point")
    parser.add_argument("--steps", action="store_true",
                        help="time CD train steps instead of a kernel")
    args = parser.parse_args()
    mode = args.kernel
    if args.request is not None:
        mode = f"request{args.request}" + (
            f"_{args.points}{'x' if args.exact else ''}" if args.points
            else "")
    elif args.steps:
        mode = "steps"

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(card, flush=True)
    if args.request is not None:
        shape = {"ratio": args.request, "points": args.points or 2048,
                 **({"patch": args.patch} if args.patch else {})}
    elif args.steps:
        shape = {"steps": args.reps}
    elif args.kernel in ("fps_bucketed", "gather_rows", "scatter_rows",
                         "knn", "knn_group", "knn_packed", "query_ball",
                         "refine_local", "refine_block"):
        shape = {"kernel": args.kernel}
    else:
        shape = {"kernel": args.kernel, "b": args.b, "n": args.n,
                 "npoint": args.npoint}
    trees = [str(pathlib.Path(t).resolve()) for t in args.trees]
    for tree in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=tree)
        run = subprocess.run(
            [sys.executable, "-c", CHILD, str(args.b), str(args.n),
             str(args.npoint), str(args.reps), mode,
             str(pathlib.Path(__file__).parent / "kernels" / "measure.py"),
             str(args.patch)],
            cwd=tree, env=env, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        result = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, **shape, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
