"""A training run's logs (counterpart of ``utils/logging.py``): scalars as
JSON lines and, where ``tensorboard`` imports, as TensorBoard events; the
epoch log, the config, a manifest or a copy of the code, and the
profiler's trace of a block (:func:`maybe_profile`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import torch

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensorboard_writer(log_dir: str):
    """A ``torch.utils.tensorboard.SummaryWriter`` into ``log_dir``, or None
    where ``tensorboard`` does not import (as in the JAX package).  Where
    TensorFlow is installed, TensorBoard imports it to write (its own
    choice, as for any user of the writer)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class MetricsLogger:
    """``scalars.jsonl`` (one record a call: step, wall time, values) and
    ``log_train.txt`` (one line a call) in ``log_dir``; the scalars and
    :meth:`image` also as TensorBoard events where a writer imports
    (``self.tb``, else None)."""

    def __init__(self, log_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self.txt_path = os.path.join(log_dir, "log_train.txt")
        self._f = open(self.path, "a")
        self.tb = _tensorboard_writer(log_dir)

    def scalars(self, step: int, values: Dict[str, float]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(k, float(v), int(step))

    def image(self, tag: str, img, step: int):
        """A (h, w) image in [0, 1] as a TensorBoard image, where a writer
        imports."""
        if self.tb is not None:
            self.tb.add_image(tag, img[None], int(step), dataformats="CHW")

    def text(self, msg: str):
        with open(self.txt_path, "a") as f:
            f.write(msg + "\n")

    def flush(self):
        """Write the TensorBoard events still queued (the JSON lines are
        flushed at each call)."""
        if self.tb is not None:
            self.tb.flush()

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()


def dump_args(log_dir: str, cfg) -> None:
    """Write the config, one ``dotted.name: value`` a line, to
    ``args.txt``."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "args.txt"), "w") as f:
        def walk(prefix, obj):
            if dataclasses.is_dataclass(obj):
                for field in dataclasses.fields(obj):
                    walk(f"{prefix}{field.name}.", getattr(obj, field.name))
            else:
                f.write(f"{prefix[:-1]}: {obj}\n")

        walk("", cfg)


@contextlib.contextmanager
def maybe_profile(log_dir: Optional[str], enable: bool = False,
                  device="cpu"):
    """With ``enable`` and a ``log_dir``, a ``torch.profiler`` trace of the
    block (CPU activity, and CUDA activity for a CUDA ``device``: each
    kernel by its ``__global__`` name) written as a Chrome trace to
    ``<log_dir>/profile/trace.json`` when the block ends; yields the
    profiler, or None when there is nothing to trace.  The trace carries
    the program's stage spans (``utils.tracing``, which record while a
    profiler does) as ``cpu_op`` events: a profiled epoch's steps split
    into ``train.draw``, ``train.forward``, ``train.losses``,
    ``train.backward`` and ``train.update``."""
    if not (enable and log_dir):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = os.path.join(log_dir, "profile")
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def backup_sources(log_dir: str, mode: str = "manifest") -> None:
    """Record the code that produced a run.  ``mode='manifest'`` (the
    default) writes ``code_manifest.txt``: the git commit and whether the
    tree is dirty (``unknown`` outside a git checkout), then a sha256 of
    each source file of the package.  ``mode='copy'`` copies the package's
    sources to ``<log_dir>/code/dispu_tpu_torch`` instead (without its
    build directory and bytecode), replacing an earlier copy."""
    if mode == "copy":
        dst = os.path.join(log_dir, "code", os.path.basename(PACKAGE))
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(PACKAGE, dst, ignore=shutil.ignore_patterns(
            "__pycache__", "*.pyc", "_build"))
        return
    if mode != "manifest":
        raise ValueError(f"mode must be 'manifest' or 'copy', got {mode!r}")
    repo = os.path.dirname(PACKAGE)
    lines = []
    try:
        head = subprocess.run(["git", "-C", repo, "rev-parse", "HEAD"],
                              capture_output=True, text=True, timeout=10)
        dirty = subprocess.run(["git", "-C", repo, "status", "--porcelain"],
                               capture_output=True, text=True, timeout=10)
        if head.returncode == 0:
            lines.append(f"commit: {head.stdout.strip()}")
            lines.append(f"dirty: {'yes' if dirty.stdout.strip() else 'no'}")
        else:
            lines.append("commit: unknown (not a git checkout)")
    except (OSError, subprocess.SubprocessError):
        lines.append("commit: unknown (no git)")
    for root, dirs, files in sorted(os.walk(PACKAGE)):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build"))
        for name in sorted(files):
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            lines.append(f"{digest}  {os.path.relpath(path, repo)}")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "code_manifest.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


class StepTimer:
    """Steps a second since construction, by the host clock."""

    def __init__(self):
        self.start = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1):
        self.steps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)
