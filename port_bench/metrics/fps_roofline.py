"""The FPS launches' share of their roofline, in %: Σ least time of a
request's two launches (the seed FPS over the normalized cloud, the merge
FPS over the candidates; ``lib/roofline.fps``) over the traced requests,
over the device time of every ``fps_kernel`` event in their trace."""

import math

from port_bench.lib import roofline


def read(run):
    tr = run.cell.traffic
    inf = run.cell.config["inference"]
    n = tr["points"]
    seeds = max(int(n / inf["patch_num_point"] * inf["patch_num_ratio"]), 1)
    passes = max(1, round(math.log(tr["ratio"], inf["step_ratio"])))
    cand = seeds * inf["patch_num_point"] * inf["step_ratio"] ** passes
    least = roofline.fps(1, n, seeds) + roofline.fps(1, cand, n * tr["ratio"])
    device = run.trace.seconds_of(["fps_kernel"])
    if device <= 0:
        return None
    return 100.0 * run.units * least / device
