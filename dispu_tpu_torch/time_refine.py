"""Time the fused refiner kernel at several layer widths on the card.

    python3 -m dispu_tpu_torch.time_refine [--b 32] [--n 1024] [--k 16]
                                           [--c 128] [--reps 10]
                                           [--mlp 128,128,256 ...]

Runs ``refine_local_cuda`` on one random grouped tensor (b, n, k, 6 + c)
with random parameters of each ``--mlp`` (c1, c2, c_out), and prints the
card's name and power limit, then one JSON line a width with the mean
milliseconds a launch (CUDA events around ``--reps`` launches after one
warm-up).  The kernel's phases scale with different widths: conv0 with
c1, conv1 and the pooling with c2, after_conv and skip with c_out, while
the grouped tile's copy, the weight net and the skip's max do not; so the
differences between widths split its time.  The default widths are
GeneratorConfig()'s refiner and the cuts that split it: (128, 128, 512)
doubles the heads, (128, 128, 4) drops most of them, (128, 4, 4) conv1
and the pooling, (4, 4, 4) conv0's columns (a product tile's rows and
columns are computed whole, so narrow widths cost a full tile).
"""

from __future__ import annotations

import argparse
import json
import subprocess

DEFAULT_MLPS = ("128,128,256", "128,128,512", "128,128,4", "128,4,4",
                "4,4,4")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--b", type=int, default=32)
    parser.add_argument("--n", type=int, default=1024)
    parser.add_argument("--k", type=int, default=16)
    parser.add_argument("--c", type=int, default=128)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--mlp", nargs="*", default=list(DEFAULT_MLPS))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_refine: no CUDA device is available")
    from dispu_tpu_torch.inference import pin_f32
    from dispu_tpu_torch.kernels.refine_local import (LocalParams,
                                                      refine_local_cuda)

    pin_f32()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator().manual_seed(0)
    cf = 6 + args.c
    grouped = torch.randn(args.b, args.n, args.k, cf,
                          generator=gen).cuda()
    for mlp in args.mlp:
        c1, c2, co = (int(w) for w in mlp.split(","))
        shapes = [(cf, c1), (c1,), (c1, c2), (c2,), (3, args.k), (args.k,),
                  (cf, co), (co,), (args.k, c2, co), (co,)]
        params = LocalParams(*(
            (torch.randn(*s, generator=gen) / s[0] ** 0.5).cuda()
            for s in shapes))
        refine_local_cuda(grouped, params)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            refine_local_cuda(grouped, params)
        end.record()
        end.synchronize()
        print(json.dumps({"b": args.b, "n": args.n, "k": args.k, "cf": cf,
                          "mlp": [c1, c2, co],
                          "ms": start.elapsed_time(end) / args.reps}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
