"""Model FLOPs of the window's completed requests over the window's time
and the peaks of their classes, in % (``lib/roofline.model_least``):
Σ over requests of the least time of their counted FLOPs / window."""

from port_bench.lib.roofline import model_least


def read(run):
    rec = run.record
    if rec["done"] <= 0 or not run.flops:
        return None
    return 100.0 * rec["done"] * model_least(run.flops) / rec["window_s"]
