"""A training run's logs (counterpart of ``utils/logging.py``): scalars as
JSON lines, the epoch log, the config and a manifest of the code.

The JAX package also writes TensorBoard events when a writer imports and
offers a profiler trace; the port writes the JSON-lines log only, and its
``profile`` setting raises (``config.check_train_supported``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import time
from typing import Dict

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class MetricsLogger:
    """``scalars.jsonl`` (one record a call: step, wall time, values) and
    ``log_train.txt`` (one line a call) in ``log_dir``."""

    def __init__(self, log_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self.txt_path = os.path.join(log_dir, "log_train.txt")
        self._f = open(self.path, "a")

    def scalars(self, step: int, values: Dict[str, float]):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def text(self, msg: str):
        with open(self.txt_path, "a") as f:
            f.write(msg + "\n")

    def close(self):
        self._f.close()


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


def backup_sources(log_dir: str) -> None:
    """Record the code that produced a run in ``code_manifest.txt``: the
    git commit and whether the tree is dirty (``unknown`` outside a git
    checkout), then a sha256 of each source file of the package."""
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
