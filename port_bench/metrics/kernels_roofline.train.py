"""The training step's own kernels' share of their roofline, in %: Σ least
time of the kNN, FPS, ball-query and attention launches a step makes,
times the traced steps, over the device time of the events of those
kernels (``knn_*``, ``fps_kernel``, ``ball_kernel``, ``attention_kernel``,
``to_bf16_kernel``) in the trace.

A CD step at batch b (patches of n points, inputs of n/4): the backbone's
feature kNN (k 17 with the duplicate bias) at c 24 once and c 48 three
times over the n/4 inputs, the refiner's xyz kNN (k 16) over the n coarse
points, the chamfer and Hausdorff terms' eight nearest-point argmins (k 1,
n × n), the repulsion's ball query (r 0.07, 20 slots, 5 chosen), the
refiner's attention over n points (c = cv = 64).  A GAN step adds the
critic's FPS seeds (n/8), its three scales' kNN (k 8, 16, 24) from the
seeds over the gt and the pred, and the ``uniform`` metric's FPS (5% of
n), five ball queries around those seeds and five kNN at k 2 within each
disk.  The lists follow ``kernels/measure.py``'s per-step counts of the
program, copied here.
"""

from port_bench.lib import roofline as R

KERNELS = ("knn_", "fps_kernel", "ball_kernel", "attention_kernel",
           "to_bf16_kernel")


def step_least(b, n, gan, k=16, nsample=16):
    m = n // 4
    t = (R.knn(b, m, m, 24, k + 1, dup=True)
         + 3 * R.knn(b, m, m, 48, k + 1, dup=True)
         + R.knn(b, n, n, 3, nsample)
         + 8 * R.knn(b, n, n, 3, 1)
         + R.ball(b, n, n, 3, 20, 5)
         + R.attention(b, n, n, 64, 64))
    if gan:
        seeds = n // 8
        t += R.fps(b, n, seeds)
        t += sum(2 * R.knn(b, n, seeds, 3, kk) for kk in (8, 16, 24))
        u = int(n * 0.05)
        t += R.fps(b, n, u)
        for p in (0.004, 0.006, 0.008, 0.010, 0.012):
            ns = max(int(n * p), 2)
            t += R.ball(b, n, u, 3, ns) + R.knn(b * u, ns, ns, 3, 2)
    return t


def read(run):
    tr = run.cell.traffic
    gan = bool(run.cell.config["use_gan"])
    least = step_least(tr["batch"], tr["patch_points"], gan)
    device = run.trace.seconds_of(KERNELS)
    if device <= 0:
        return None
    return 100.0 * run.units * least / device

