"""Measure the tracer (``utils/tracing.py``) on the card: what a span costs
off and on, what the sync counter costs a sync, whether its counts match
the profiler's synchronizing runtime calls, and whether the spans' clock
is the profiler's.

    python3 -m dispu_tpu_torch.time_tracing [--units 3] [--out FILE]

The units, at the benchmark's sizes from the seeded init: a 4× and a 16×
request of one 2,048-point cloud (``upsample``), a CD and a GAN step at
batch 28 of 1,024-point patches (``GeneratorConfig()``,
``ExperimentConfig()``), each warmed twice; and ``dup_rows``, one
``duplicate_rows_torch`` call at a dense block's shape (32 × 256 × 24)
in a span of its own.  Prints the card's name and
power limit, then for each unit:

- ``spans``: the spans a unit opens, by name in order;
- ``syncs``: the counter's waits a unit (its outermost span,
  ``serve.request`` or ``train.step``) and ``profiler_syncs`` the profiler's calls of
  ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize`` and ``cudaMemcpy`` (synchronous) inside the
  same units, with ``sync_ops`` the innermost operator (``cpu_op``) that
  made each call, and ``sync_spans`` the counter's waits by span;
- ``host_ms``: the median host ms of the unit's call (no synchronize
  after it) off and under ``tracing.recording()``, in turns, and under
  the profiler;
- ``clock_us``: the least, median and largest µs from a span's
  ``cpu_op`` event in the profiler's trace (``trace_start_ns`` + the
  event's start) to its record's start;
- ``on_device``: program span names found among the device's events
  (none expected), and the categories of the spans' Chrome events;
- ``cost_us``: what the tracer adds to a unit, from the costs below: its
  spans off; on, with its syncs counted.

Then ``span_off_us`` and ``span_on_us`` (a ``with span():`` around
nothing, less an empty loop; on under ``recording()`` nested in an open
span, and under the profiler) and ``sync_us``, the counter's cost a sync
(``.item()`` of a device scalar inside a span under ``recording()``, less
the same off).  The whole result goes to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dispu_tpu_torch.utils import tracing

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def is_sync_call(name: str) -> bool:
    """A runtime call that waits for the device (the per-thread default
    stream's ``_ptsz`` / ``_ptds`` forms too)."""
    return name.split("_pt")[0] in SYNC_CALLS


def build_units(dev):
    """{unit: a function that runs one}."""
    from dispu_tpu_torch.config import (ExperimentConfig, GeneratorConfig,
                                        InferenceConfig, TrainConfig)
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step

    cloud = np.random.RandomState(0).randn(2048, 3).astype(np.float32)
    units = {}
    for ratio in (4, 16):
        up = PatchUpsampler(None, GeneratorConfig(),
                            InferenceConfig(final_ratio=ratio), device=dev)
        units[f"up{ratio}x"] = (lambda up=up: up.upsample(cloud))
    cfg = ExperimentConfig(train=TrainConfig(batch_size=28))
    gt = torch.rand(28, 1024, 3, generator=torch.Generator().manual_seed(1)
                    ).to(dev) - 0.5
    radius = torch.ones(28, device=dev)
    for name, gan in (("cd", False), ("gan", True)):
        c = dataclasses.replace(cfg, use_gan=gan)
        box = {"state": create_gan_state(c, device=dev) if gan
               else create_generator_state(c.generator, device=dev),
               "step": (make_gan_train_step if gan else make_train_step)(
                   c, device=dev),
               "gen": torch.Generator(device=dev).manual_seed(2)}

        def run(box=box):
            box["state"], _ = box["step"](box["state"], gt, radius,
                                          box["gen"])
        units[name] = run
    from dispu_tpu_torch.kernels.knn import duplicate_rows_torch

    feats = torch.randn(32, 256, 24, device=dev)
    feats[:, 200:] = feats[:, :56]  # duplicate rows, as padding makes

    def dup_rows():
        with tracing.span("dup_rows"):
            duplicate_rows_torch(feats)
    units["dup_rows"] = dup_rows
    return units


def host_ms(fn, n):
    """{mode: median host ms of ``fn()``} over ``n`` calls a mode, a
    synchronize after each (outside the timed part): ``off`` and
    ``recording`` in turns, then ``profiler``."""
    from torch.profiler import ProfilerActivity, profile

    modes = {"off": contextlib.nullcontext, "recording": tracing.recording}
    out: dict = {m: [] for m in (*modes, "profiler")}

    def once(mode):
        t0 = time.perf_counter()
        fn()
        out[mode].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()

    for _ in range(n):
        for mode, ctx in modes.items():
            with ctx():
                once(mode)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(n):
            once("profiler")
    tracing.clear()
    return {m: statistics.median(v) for m, v in out.items()}


def profile_unit(fn, n):
    """Run ``fn`` ``n`` times under the profiler; (records, events,
    trace_start_ns, chrome categories of the program's spans)."""
    from torch.profiler import ProfilerActivity, profile

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    records = tracing.records()
    events = list(prof.events())
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    names = {r.name for r in records}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            cats = sorted({e.get("cat", "") for e in
                           json.load(f)["traceEvents"]
                           if e.get("name") in names})
    return records, events, start_ns, cats


def compare(records, events, start_ns):
    """The counter's syncs against the profiler's sync calls inside the
    root spans, the calls by operator, and the clock gap."""
    from torch.autograd import DeviceType

    roots = [r for r in records if r.parent is None]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]

    def rel_us(ns):
        return (ns - start_ns) / 1e3

    windows = [(rel_us(r.t0_ns), rel_us(r.t1_ns)) for r in roots]
    calls = [e for e in cpu if is_sync_call(e.name)
             and any(a <= e.time_range.start < b for a, b in windows)]
    ops: dict = {}
    for c in calls:
        inner = [e for e in cpu if e is not c and e.thread == c.thread
                 and not is_sync_call(e.name)
                 and e.time_range.start <= c.time_range.start
                 and c.time_range.end <= e.time_range.end]
        name = (max(inner, key=lambda e: e.time_range.start).name
                if inner else "?")
        key = f"{name} > {c.name}"
        ops[key] = ops.get(key, 0) + 1
    # each record against its own cpu_op event: same name, same order
    gaps = []
    for name in {r.name for r in records}:
        mine = [r for r in records if r.name == name]
        theirs = sorted((e for e in cpu if e.name == name),
                        key=lambda e: e.time_range.start)
        if len(mine) == len(theirs):
            gaps += [rel_us(r.t0_ns) - e.time_range.start
                     for r, e in zip(mine, theirs)]
    by_span: dict = {}
    for r in records:
        by_span[r.name] = by_span.get(r.name, 0) + r.syncs
    device = sorted({e.name for e in events
                     if e.device_type == DeviceType.CUDA}
                    & {r.name for r in records})
    return {"units": len(roots),
            "syncs": sum(r.syncs for r in roots) / max(len(roots), 1),
            "profiler_syncs": len(calls) / max(len(roots), 1),
            "sync_ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])),
            "sync_spans": by_span,
            "clock_us": [min(gaps), statistics.median(gaps), max(gaps)]
            if gaps else None,
            "clock_pairs": len(gaps), "on_device": device}


def loop_us(body, n):
    t0 = time.perf_counter()
    body(n)
    return (time.perf_counter() - t0) / n * 1e6


def span_costs(n=200_000):
    """µs a span: off, on under ``recording()`` (nested in an open span,
    so the counter is already on), on under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    span = tracing.span

    def empty(k):
        for _ in range(k):
            pass

    def spans(k):
        for _ in range(k):
            with span("cost"):
                pass

    def best(body, k, reps=5):
        return min(loop_us(body, k) for _ in range(reps))

    base = best(empty, n)
    out = {"span_off_us": best(spans, n) - base}
    with tracing.recording(), span("outer"):
        out["span_on_us"] = best(spans, n // 10) - base
    with profile(activities=[ProfilerActivity.CPU]):
        with span("outer"):
            out["span_profiled_us"] = best(spans, n // 10) - base
    tracing.clear()
    return out


def sync_cost(dev, n=2000):
    """µs the counter adds to one counted wait: ``.item()`` of a device
    scalar, in a span under ``recording()`` less the same off."""
    x = torch.ones((), device=dev)

    def items(k):
        for _ in range(k):
            x.item()

    off = min(loop_us(items, n) for _ in range(5))
    with tracing.recording(), tracing.span("sync"):
        on = min(loop_us(items, n) for _ in range(5))
    counted = tracing.records()[-1].syncs
    tracing.clear()
    return {"sync_us": on - off, "item_us": off,
            "counted": counted, "expected": 5 * n}


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--units", type=int, default=3)
    parser.add_argument("--host_reps", type=int, default=10)
    parser.add_argument("--out", default="time_tracing.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_tracing: no CUDA device is available", file=sys.stderr)
        return 2
    from dispu_tpu_torch.inference import pin_f32

    pin_f32()
    dev = torch.device("cuda")
    result = {"card": card(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(json.dumps(result), flush=True)
    result.update(span_costs())
    result.update(sync_cost(dev))
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("card", "torch", "cuda")}), flush=True)
    for name, fn in build_units(dev).items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        tracing.clear()
        with tracing.recording():
            fn()
        torch.cuda.synchronize()
        spans = [r.name for r in tracing.records()]
        row = {"spans": spans, "n_spans": len(spans),
               "host_ms": host_ms(fn, args.host_reps)}
        records, events, start_ns, cats = profile_unit(fn, args.units)
        row.update(compare(records, events, start_ns), chrome_cats=cats)
        n, syncs = len(spans), row["syncs"]
        row["cost_us"] = {
            "off": n * result["span_off_us"],
            "recording": n * result["span_on_us"] + syncs * result["sync_us"],
            "profiler": n * result["span_profiled_us"]
            + syncs * result["sync_us"]}
        result[name] = row
        print(json.dumps({name: row}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
