#!/usr/bin/env python3
"""Hold ``refine_local_impl='megafused'`` against the composed path over
generator seeds on an NVIDIA GPU, by both of the comparisons
``chip_smoke.py`` knows.

    python3 refine_sweep.py [--seeds 8] [--ratio 4]

For each seed, builds ``PatchUpsampler(seed=...)`` twice at full
``GeneratorConfig()`` width: with ``refine_local_impl='megafused'``, and
with the composed refiner gathering bf16 features (``fast_gather``), both
through the kernels, as ``chip_smoke.py``'s ``serve_refine`` does for seed
0.  On the two demo clouds (``upsample`` of each, ``upsample_many`` of
both) it prints one JSON line a seed with the symmetric Chamfer distance
between the two paths' outputs, for each of the four outputs, and the
largest difference of their generator rows before the merge
(``chip_smoke.merge_candidates``), for each of the three calls; then a
last line with how many outputs exceed ``chip_smoke.py``'s Chamfer limit
for the ratio and how many calls exceed its row limit ``MEGA_GEN_ABS``.  The two paths differ in the f32
sum order of the refiner's local branch, so their merge candidates
differ in the last bit of some rows, and the exact merge FPS, a chain of
argmaxes, may then take another point: one point of 8,192 moves the
Chamfer distance by ~5e-9.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import chip_smoke


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--ratio", type=int, default=4)
    args = parser.parse_args()

    import numpy as np
    import torch

    from dispu_tpu_torch import GeneratorConfig, InferenceConfig
    from dispu_tpu_torch.inference import PatchUpsampler

    if not torch.cuda.is_available():
        raise SystemExit("refine_sweep: no CUDA device is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    print(card, flush=True)
    clouds = [chip_smoke.load_cloud(name)
              for name in ("Icosahedron.xyz", "fandisk.xyz")]
    batches = [pc[None] for pc in clouds] + [np.stack(clouds)]
    inf = InferenceConfig(final_ratio=args.ratio)
    limit = chip_smoke.CHAMFER_MAX[args.ratio]
    past_cd = past_rows = outputs = calls = 0
    for seed in range(args.seeds):
        ups = [PatchUpsampler(gen_cfg=cfg, inf_cfg=inf, seed=seed)
               for cfg in (GeneratorConfig(refine_local_impl="megafused"),
                           GeneratorConfig(fast_gather=True))]
        cds, rows = [], []
        for pcs in batches:
            mine, theirs = (up.upsample_many(pcs) for up in ups)
            cds += [chip_smoke.chamfer(a, b) for a, b in zip(mine, theirs)]
            gen = [chip_smoke.merge_candidates(up, pcs)[0] for up in ups]
            rows.append(float(torch.abs(gen[0] - gen[1]).amax()))
        past_cd += sum(c > limit for c in cds)
        past_rows += sum(r > chip_smoke.MEGA_GEN_ABS for r in rows)
        outputs += len(cds)
        calls += len(rows)
        print(json.dumps({"seed": seed, "ratio": args.ratio, "chamfer": cds,
                          "generator_rows_max_abs": rows}), flush=True)
    print(json.dumps({"ratio": args.ratio, "outputs": outputs,
                      f"chamfer_past_{limit}": past_cd, "calls": calls,
                      f"rows_past_{chip_smoke.MEGA_GEN_ABS}": past_rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
