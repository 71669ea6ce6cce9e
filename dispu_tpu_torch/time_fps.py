"""Time ``farthest_point_sample`` of one or more checkouts on the card.

    python3 -m dispu_tpu_torch.time_fps [--b 1] [--n 98304] [--npoint 32768]
                                        [--reps 3] [--kernel fps_chunked]
                                        [TREE ...]

Each TREE is the root of a checkout of this repository (default: the one
this module lies in).  Every tree's own
``dispu_tpu_torch.ops.sampling.farthest_point_sample`` runs in a process of
its own on the same input (``torch.randn`` from seed 0, with the first
100 points copied further on, so that tied distances occur), first in the
order given and then in reverse (a, b, b, a), and is timed with CUDA
events after one warm-up call.  Prints the card's name and power limit,
then one JSON line a run with the mean milliseconds a call and a digest of
the indices, which must agree between trees that compute the same
function.  ``--kernel fps`` or ``--kernel fps_chunked`` times that
kernel's wrapper instead of the route, at any n it takes.  Two trees are
compared only within one such call.  This is how the device-scratch form
of ``fps.cu``, which the cluster kernel ``fps_chunked.cu`` replaced at the
16× merge shape, was timed: on a checkout of the commit before the
replacement; and so was the one-block ``fps.cu`` that its register and
cluster forms replaced.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

CHILD = r"""
import hashlib, importlib, json, sys, torch
b, n, npoint, reps = map(int, sys.argv[1:5])
if sys.argv[5] == "route":
    from dispu_tpu_torch.ops.sampling import farthest_point_sample
else:
    module = importlib.import_module("dispu_tpu_torch.kernels." + sys.argv[5])
    farthest_point_sample = getattr(module, sys.argv[5] + "_cuda")
gen = torch.Generator().manual_seed(0)
xyz = torch.randn(b, n, 3, generator=gen)
xyz[:, n - 100:] = xyz[:, :100]
xyz = xyz.cuda()
out = farthest_point_sample(npoint, xyz)
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(reps):
    farthest_point_sample(npoint, xyz)
end.record()
end.synchronize()
digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
print(json.dumps({"ms": start.elapsed_time(end) / reps, "digest": digest}))
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
                        choices=("route", "fps", "fps_chunked"))
    args = parser.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(card, flush=True)
    trees = [str(pathlib.Path(t).resolve()) for t in args.trees]
    for tree in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=tree)
        run = subprocess.run(
            [sys.executable, "-c", CHILD, str(args.b), str(args.n),
             str(args.npoint), str(args.reps), args.kernel],
            cwd=tree, env=env, capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        result = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, "kernel": args.kernel, "b": args.b,
                          "n": args.n, "npoint": args.npoint, **result}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
