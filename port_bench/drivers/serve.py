"""Closed-loop whole-cloud requests: one caller sends a cloud to
``PatchUpsampler.upsample`` and waits for its numpy answer before the
next, cycling through a pool of clouds made from the seed, as a user
upsampling a test set does.

The harness records, without changing what runs: each request's host
latency (the call until its answer returns); with ``--trace 1`` CUDA
events around the program's ``prepare``, ``generate`` and ``merge`` (its
instance's methods wrapped, no synchronize between them); and, for the
clouds drawn for the check, what each stage produced (the wrappers and a
forward hook on the generator keep references), so that the check reads
the timed path's own results.
"""

from __future__ import annotations

import math
import time
import traceback

import numpy as np
import torch

from port_bench.lib import data
from port_bench.lib.cell import dataclass_args
from port_bench.lib.check import serve_numbers
from port_bench.lib.timing import Clock, slice_rates


class Recorder:
    """Wraps one upsampler's stages.  ``slot``: a dict to fill with this
    request's stages, or None; ``events``: a list to append this request's
    six CUDA events to, or None."""

    def __init__(self, up):
        self.slot = None
        self.events = None
        self.spans = False
        self.up = up
        for stage in ("prepare", "generate", "merge"):
            setattr(up, stage, self._wrap(stage, getattr(up, stage)))
        up.model.register_forward_hook(self._hook)

    def _wrap(self, stage, fn):
        from torch.profiler import record_function

        def wrapped(*args, **kwargs):
            ev = self.events
            if ev is not None:
                ev.append(torch.cuda.Event(enable_timing=True))
                ev[-1].record()
            if self.spans:
                with record_function(f"bench.{stage}"):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if ev is not None:
                ev.append(torch.cuda.Event(enable_timing=True))
                ev[-1].record()
            slot = self.slot
            if slot is not None:
                if stage == "prepare":
                    slot.update(cloud_n=args[0], patches=out[0],
                                p_centroid=out[1], p_furthest=out[2],
                                seeds=out[3], passes=[])
                elif stage == "generate":
                    slot["gen_out"] = out
                else:
                    slot.update(merge_in=args[0], merged=out)
            return out
        return wrapped

    def _hook(self, module, args, output):
        if self.slot is not None:
            self.slot["passes"].append((args[0], output[1]))


class Driver:
    """Set-up, window, traced sub-window and check of one serving cell.

    Set-up is :meth:`inputs` (the weights and the pool of clouds, all the
    reference needs), :meth:`build` (the program) and :meth:`warm`."""

    def __init__(self, cell, seed, device, log=None):
        clock = Clock(log)
        self.inputs(cell, seed, device)
        clock("weights and clouds")
        self.build()
        clock("program")
        self.warm(clock)

    def inputs(self, cell, seed, device):
        from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig

        cfg, tr = cell.config, cell.traffic
        self.cell, self.device = cell, device
        self.ratio = tr["ratio"]
        self.gen_cfg = GeneratorConfig(**dataclass_args(cfg["generator"]))
        self.inf_cfg = InferenceConfig(**dict(
            dataclass_args(cfg["inference"]), final_ratio=self.ratio))
        self.weights = data.weights(cfg["weights"]["generator"], seed,
                                    device)
        self.pool = data.make(tr["shape"], tr["pool"], tr["points"],
                              tr["shape_params"], seed, device)
        self.clouds = self.pool.cpu().numpy()
        self.order = data.host_rng(seed, 3).permutation(tr["pool"])
        self.checked = set(data.host_rng(seed, 4).choice(
            tr["pool"], tr["check_clouds"], replace=False).tolist())
        self.caps: dict = {}
        self.sent = self.errors = 0

    def build(self):
        from dispu_tpu_torch.inference import PatchUpsampler

        self.up = PatchUpsampler(None, self.gen_cfg, self.inf_cfg,
                                 device=self.device)
        self.up.model.load_state_dict(self.weights)
        self.rec = Recorder(self.up)

    def warm(self, clock):
        for i in range(self.cell.traffic["warm_requests"]):
            self.request()
            clock(f"warm request {i + 1}")

    def request(self):
        """One request of the loop: (latency seconds, ok)."""
        c = int(self.order[self.sent % len(self.order)])
        self.sent += 1
        slot = {} if c in self.checked else None
        self.rec.slot = slot
        t0 = time.perf_counter()
        try:
            out = self.up.upsample(self.clouds[c])
            ok = True
        except RuntimeError:
            if not self.errors:
                traceback.print_exc()
            self.errors += 1
            ok = False
        dt = time.perf_counter() - t0
        if slot is not None and ok:
            slot["out"] = out
            self.caps[c] = slot
        self.rec.slot = None
        return dt, ok

    def window(self, seconds, traced):
        """Requests until ``seconds`` have passed; with ``traced`` each
        request's stage events too.  Returns the record."""
        lat, done_at, failed, events = [], [], 0, []
        stage_events = traced and self.device.type == "cuda"
        self.caps.clear()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if stage_events:
                self.rec.events = []
            dt, ok = self.request()
            if stage_events:
                events.append(self.rec.events)
                self.rec.events = None
            lat.append(dt)
            done_at.append(time.perf_counter() - t0)
            failed += not ok
        window_s = time.perf_counter() - t0
        return dict(attempted=len(lat), done=len(lat) - failed,
                    failed=failed, window_s=window_s, latencies=lat,
                    done_at=done_at, events=events)

    def metrics(self, record):
        lat = np.asarray(record["latencies"])
        return {"clouds_per_s": record["done"] / record["window_s"],
                "request_ms_p95": float(np.percentile(lat, 95) * 1e3)
                if len(lat) else math.nan}

    def log_window(self, record, log):
        lat = record["latencies"]
        if lat:
            print("latency ms: first " + " ".join(
                f"{x * 1e3:.1f}" for x in lat[:8])
                + f"; max {max(lat) * 1e3:.1f} at {lat.index(max(lat))}",
                file=log)
        print("clouds/s by 5 s: " + " ".join(
            f"{r:.2f}" for r in slice_rates(record["done_at"],
                                            record["window_s"])), file=log)

    def run_n(self, n):
        """``n`` requests inside harness spans (the traced sub-window)."""
        from torch.profiler import record_function

        self.rec.spans = True
        for _ in range(n):
            with record_function("bench.request"):
                self.request()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rec.spans = False

    def flops_per_unit(self):
        """{dtype: model FLOPs} of one request's own patches, counted over
        the reference at one patch a pass on the CPU: a pass's FLOPs are
        linear in its patches."""
        from port_bench.lib.counting import request_flops

        n = self.clouds.shape[1]
        inf = self.inf_cfg
        seeds = max(int(n / inf.patch_num_point * inf.patch_num_ratio), 1)
        return request_flops(self.weights, self.ratio, seeds,
                             inf.patch_num_point)

    def free_program(self):
        self.up = self.rec.up = None

    def check(self, bf16):
        cs = sorted(self.caps)
        if not cs:
            return {}
        return serve_numbers(self.weights, [self.pool[c] for c in cs],
                             [self.caps[c] for c in cs], bf16)
