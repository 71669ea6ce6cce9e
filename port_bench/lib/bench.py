"""One run of one cell: set-up, the measured window, with ``trace`` the
traced sub-window, then the check; the result as one JSON line.

The cell's traffic mix names its driver (``drivers/<driver>.py``), which
every cell drives through the same calls; every other difference between
cells lives in the files that ``lib/cell.py`` reads.  The end-to-end
metrics come from the untraced window by the host's clock; a ``--trace
1`` run measures its window the same way for the readers that need it
(model FLOPs a second, stage events, host enqueue times), then profiles
``profile_units`` more requests or steps for the device's busy and idle
time, the kernels' time and the breakdown, and reports the per-layer
metrics.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from port_bench.lib import check as checks
from port_bench.lib.cell import Cell, driver, metric_reader


class Run:
    """What a metric reader reads: the cell, the window record, the model
    FLOPs of one unit, the trace of the profiled sub-window and how many
    units it holds."""

    def __init__(self, cell, record, flops, trace, units):
        self.cell, self.record = cell, record
        self.flops, self.trace, self.units = flops, trace, units


def run(workload, seed, seconds, trace, device, started, log=sys.stderr):
    """The result dict of one run."""
    cell = Cell(workload)
    Driver = driver(cell.traffic["driver"])
    bf16 = device.type == "cuda"
    torch.manual_seed(0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    drv = Driver(cell, seed, device, log=log)
    setup_s = time.time() - started
    print(f"set-up {setup_s:.3f} s", file=log)
    record = drv.window(seconds, traced=bool(trace))
    drv.log_window(record, log)
    result = {"correct": False, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": {},
              "device": device_info(device)}
    values = dict(drv.metrics(record), setup_s=setup_s)
    if trace:
        from port_bench.lib.trace import profiled

        flops = drv.flops_per_unit()
        n_prof = cell.traffic["profile_units"]
        with profiled(device) as box:
            drv.run_n(n_prof)
        tr = box["trace"]
        r = Run(cell, record, flops, tr, n_prof)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(r)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    else:
        for m in cell.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
    if device.type == "cuda":
        result["device"]["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    drv.free_program()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    numbers = drv.check(bf16)
    ok, rows = checks.judge(numbers, cell.limits)
    print(f"check {time.time() - t0:.3f} s", file=log)
    for k, v in sorted(numbers.items()):
        if k not in cell.limits:
            print(f"  (info) {k} {v}", file=log)
    for name, value, limit in rows:
        print(f"{name} {value} limit {limit}", file=log)
    result["correct"] = bool(ok and record["done"] > 0
                             and record["failed"] == 0
                             and all(math.isfinite(m["value"])
                                     for m in result["metrics"].values()))
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return result


def device_info(device):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
