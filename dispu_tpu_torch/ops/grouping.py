"""Neighbourhood gathers (counterpart of ``ops/grouping.py``).

Every exact gather of the JAX package ('gather', and the one-hot MXU
contractions 'onehot_hp', 'onehot3' and 'pallas', which it proves
bit-identical to a gather) is one plain index gather here: on the card a
load is exact, so the TPU's one-hot detour has no reason to exist.
"""

from __future__ import annotations

import torch

from dispu_tpu_torch.config import EXACT_GATHERS
from dispu_tpu_torch.ops.knn import knn_indices


def group_point(points: torch.Tensor, idx: torch.Tensor,
                impl: str = "gather") -> torch.Tensor:
    """(b, n, c) points, (b, m, k) indices → (b, m, k, c)."""
    if impl not in EXACT_GATHERS:
        raise NotImplementedError(
            f"group_point impl={impl!r} is not ported yet (ROADMAP.md, "
            "queue 1: turbo and opt-in paths)"
        )
    b, m, k = idx.shape
    c = points.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(b, m * k, c)
    return torch.gather(points, 1, flat).reshape(b, m, k, c)


def grouping(feature: torch.Tensor, k: int, src_xyz: torch.Tensor,
             q_xyz: torch.Tensor, use_xyz: bool = True,
             gather_impl: str = "gather", impl: str = "auto"):
    """kNN neighbourhoods of the query points with their gathered features.

    Returns (grouped_xyz (b, m, k, 3), grouped_feature (b, m, k, 3 + c or
    c), idx (b, m, k)).  One combined ``[xyz | feature]`` gather, as on the
    JAX package's exact path.  The ball-query branch (``use_knn=False``)
    comes with the ball-query kernel.
    """
    idx = knn_indices(k, src_xyz, q_xyz, impl=impl)
    combined = group_point(torch.cat([src_xyz, feature], dim=-1), idx,
                           impl=gather_impl)
    grouped_xyz = combined[..., :3]
    grouped_feature = combined if use_xyz else combined[..., 3:]
    return grouped_xyz, grouped_feature, idx
