"""Checkpoint save and restore (counterpart of ``utils/checkpoint.py``).

A checkpoint is ``<log_dir>/model-<epoch>.pt``: a ``torch.save`` of the
whole training state (parameters, batch-norm statistics, Adam moments,
count, epoch and step; a GAN state holds the generator's under ``gen`` and
the critic's beside it), so a restore is an exact resume point.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

_CKPT_RE = re.compile(r"model-(\d+)\.pt$")


def save_checkpoint(log_dir: str, state, epoch: int) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"model-{epoch}.pt")
    torch.save(state.state_dict(), path)
    return path


def latest_checkpoint(log_dir: str) -> Tuple[int, Optional[str]]:
    """Newest checkpoint in ``log_dir`` by the epoch in its name, as
    (epoch, path), or (-1, None)."""
    best = (-1, None)
    if not os.path.isdir(log_dir):
        return best
    for name in os.listdir(log_dir):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best[0]:
            best = (int(m.group(1)), os.path.join(log_dir, name))
    return best


def restore_checkpoint(path: str, state):
    """Load a checkpoint written by :func:`save_checkpoint` into ``state``
    (a state of the same configuration), on ``state``'s device."""
    device = next(state.model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    return state.load_state_dict(saved)
