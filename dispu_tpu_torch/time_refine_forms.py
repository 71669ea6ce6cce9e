"""Time edited copies of the fused refiner kernels side by side on the card.

    python3 -m dispu_tpu_torch.time_refine_forms [--reps 10]
        [--only NAME ...] [--kernels refine_local,refine_block]
        [VARIANTS.json]

A variant is a copy of the package with literal text replacements in
``kernels/csrc``: each edit is ``[old, new]`` in ``refine_common.cuh`` or
``[file, old, new]``;
VARIANTS.json holds ``{name: [edit, ...]}`` and the built-in ones are
:data:`VARIANTS` (the unedited sources run as ``shipped``; ``--only``
picks some by name).  Every copy is built at once (``nvcc`` through the
copy's own ``kernels/_build.py``) in a temporary directory and timed in a
process of its own: ``refine_local_cuda`` and ``refine_block_cuda`` (or
the ``--kernels`` named) at every shape of ``measure.REFINE_CASES``
(parameters from ``measure.refine_params`` with seed 12, then random
grouped rows, points and features), by CUDA events around ``--reps``
back-to-back calls after one warm-up, with max |kernel − plain version|
over max(|plain|, 1); beside ``refine_block`` (whose call is
``knn_cuda``'s launch of its selection and the block's), ``knn_cuda``'s
own ms at the shape.  The
variants that cut a part out are bounds: their outputs are wrong by
design.  Prints the card's name and power limit, then one JSON line a
variant: each kernel and shape's ms and error, the clusters the card
holds at once, the block's shared memory, and each kernel's registers and
spills from its build.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

#: the ring's depth and the cluster's size around the shipped ones (two
#: 32 KB buffers, a pair of blocks), and bounds that cut one part out
VARIANTS = {
    "ring 3 x 24 KB": [["constexpr int kStages = 2;",
                        "constexpr int kStages = 3;"],
                       ["constexpr int kStageBytes = 32768;",
                        "constexpr int kStageBytes = 24576;"]],
    "ring 4 x 16 KB": [["constexpr int kStages = 2;",
                        "constexpr int kStages = 4;"],
                       ["constexpr int kStageBytes = 32768;",
                        "constexpr int kStageBytes = 16384;"]],
    "cluster of 4": [["constexpr int kCluster = 2;",
                      "constexpr int kCluster = 4;"]],
    "cluster of 8": [["constexpr int kCluster = 2;",
                      "constexpr int kCluster = 8;"]],
    "no head products": [["    mma(hh[j], ah, bh[0], bh[1]);\n"
                          "    mma(sml[j], al, bh[0], bh[1]);\n"
                          "    mma(sml[j], ah, bl[0], bl[1]);\n", ""]],
    "no conv products": [["      mma(s, al[i], bh[0], bh[1]);\n"
                          "      mma(s, ah[i], bl[0], bl[1]);\n"
                          "      mma(s, ah[i], bh[0], bh[1]);\n", ""]],
    "no pooling": [["    pool_query(wts", "    if (0) pool_query(wts"]],
    "no exchange": [["e < 2 * ldp; e += kCompute) dst[e] = src[e];",
                     "e < 0; e += kCompute) dst[e] = src[e];"]],
    "no tile copy": [["refine_local.cu", "    copy_rows(grouped",
                      "    if (0) copy_rows(grouped"]],
}

CHILD = r"""
import ctypes, json, sys, torch
from dispu_tpu_torch.inference import pin_f32
from dispu_tpu_torch.kernels import _build, knn, measure, refine_block
from dispu_tpu_torch.kernels import refine_local
pin_f32()
reps = int(sys.argv[1])
kernels = sys.argv[2].split(",")
gen = torch.Generator().manual_seed(12)
cases = measure.REFINE_CASES
p = refine_local.LocalParams(*(t.cuda() for t in
                               measure.refine_params(gen, cases[0])))


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


def err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1.0)


out = {}
for case in cases:
    g = torch.randn(case.b, case.n, case.k, 6 + case.c, generator=gen)
    xyz = torch.randn(case.b, case.n, 3, generator=gen).cuda()
    feats = torch.randn(case.b, case.n, case.c, generator=gen).cuda()
    if "refine_block" in kernels:
        got, idx = refine_block.refine_block_cuda(xyz, feats, p,
                                                  with_idx=True)
        out["refine_block " + case.label] = {
            "ms": event_ms(lambda: refine_block.refine_block_cuda(xyz, feats,
                                                                  p)),
            "err": err(got, refine_block.refine_block_torch(xyz, feats, p,
                                                            idx=idx)),
            "knn_ms": event_ms(lambda: knn.knn_cuda(case.k, xyz, xyz))}
    if "refine_local" in kernels:
        g = g.cuda()
        out["refine_local " + case.label] = {
            "ms": event_ms(lambda: refine_local.refine_local_cuda(g, p)),
            "err": err(refine_local.refine_local_cuda(g, p),
                       refine_local.refine_local_torch(g, p))}
        del g
case = cases[0]
lib = _build.load("refine_local")
lib.dispu_refine_local_smem.argtypes = [ctypes.c_int] * 6
lib.dispu_refine_local_smem.restype = ctypes.c_size_t
smem = lib.dispu_refine_local_smem(case.k, 6 + case.c, *case.mlp, 8)
lib.dispu_refine_local_clusters.argtypes = [ctypes.c_size_t]
builds = {}
for name in ("refine_local", "refine_block"):
    builds[name] = [line.strip() for line in _build.build_log(name)
                    .splitlines() if "spill" in line or "Used" in line]
print(json.dumps({"smem": smem,
                  "clusters": lib.dispu_refine_local_clusters(smem),
                  "shapes": out, "builds": builds}))
"""


def _copy(root: pathlib.Path, tmp: pathlib.Path, name: str,
          edits) -> pathlib.Path:
    tree = tmp / name.replace(" ", "_")
    shutil.copytree(root / "dispu_tpu_torch", tree / "dispu_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = tree / "dispu_tpu_torch" / "kernels" / "csrc"
    for edit in edits:
        fname, old, new = (edit if len(edit) == 3
                           else ["refine_common.cuh", *edit])
        path = csrc / fname
        text = path.read_text()
        if old not in text:
            raise ValueError(f"variant {name!r}: {old!r} not in {fname}")
        path.write_text(text.replace(old, new))
    return tree


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variants", nargs="?", default=None,
                        help="a JSON file of variants (default: built-in)")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--only", nargs="+", default=None, metavar="NAME",
                        help="these variants alone")
    parser.add_argument("--kernels", default="refine_local,refine_block",
                        help="the kernels timed, comma-separated")
    args = parser.parse_args()
    variants = (json.loads(pathlib.Path(args.variants).read_text())
                if args.variants else VARIANTS)
    if args.only:
        variants = {name: variants[name] for name in args.only}
    root = pathlib.Path(__file__).resolve().parents[1]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        trees = {"shipped": _copy(root, pathlib.Path(tmp), "shipped", [])}
        for name, edits in variants.items():
            trees[name] = _copy(root, pathlib.Path(tmp), name, edits)
        builds = {name: subprocess.Popen(
            [sys.executable, "-c", "from dispu_tpu_torch.kernels import "
             "_build; _build.build(('refine_local', 'refine_block'))"],
            cwd=tree, env=dict(os.environ, PYTHONPATH=str(tree)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, tree in trees.items()}
        for name, proc in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"{name}: build failed\n{log}", file=sys.stderr)
                return proc.returncode
        for name, tree in trees.items():
            run = subprocess.run(
                [sys.executable, "-c", CHILD, str(args.reps), args.kernels],
                cwd=tree,
                env=dict(os.environ, PYTHONPATH=str(tree)),
                capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                print(run.stdout + run.stderr, file=sys.stderr)
                return run.returncode
            print(json.dumps({"variant": name, **json.loads(
                run.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
