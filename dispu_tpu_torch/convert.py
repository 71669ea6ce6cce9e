"""Load a flax variable tree into the port's modules.

The JAX package's variables are ``{'params': ..., 'batch_stats': ...}``
nested by module scope.  The port names its submodules by the same scopes,
so a leaf's path maps onto a ``state_dict`` key by joining it with dots,
with one rename: a dense ``kernel`` (stored (in, out)) becomes ``weight``
((out, in), transposed).  ``_PermutedRowDense`` keeps its stored row
layout and permutes at apply time, so its kernel converts like any other.
Batch-norm ``scale``/``bias`` and ``mean``/``var`` keep their names.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

COLLECTIONS = ("params", "batch_stats")


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[tuple]:
    for name, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _leaves(value, prefix + (str(name),))
        else:
            yield prefix + (str(name),), value


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(state_dict key, whether the value is transposed)."""
    if path[-1] == "kernel":
        return ".".join(path[:-1] + ("weight",)), True
    return ".".join(path), False


def from_flax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Fill every parameter and buffer of ``model`` from ``variables``.

    ``variables`` holds nested dicts of arrays (numpy or anything
    ``np.asarray`` takes).  Raises ``ValueError`` on a leaf that maps to
    nothing, a shape that differs, or a parameter or buffer left unfilled.
    """
    state = model.state_dict()
    values: Dict[str, np.ndarray] = {}
    unused = []
    for collection in variables:
        if collection not in COLLECTIONS:
            unused.append(collection)
            continue
        for path, leaf in _leaves(variables[collection]):
            key, transpose = _torch_key(path)
            if key not in state:
                unused.append(f"{collection}/{'/'.join(path)}")
                continue
            arr = np.asarray(leaf, np.float32)
            if transpose:
                arr = arr.T
            if tuple(arr.shape) != tuple(state[key].shape):
                raise ValueError(
                    f"{collection}/{'/'.join(path)}: shape {arr.shape} does "
                    f"not fit {key} {tuple(state[key].shape)}"
                )
            values[key] = arr
    missing = sorted(set(state) - set(values))
    if unused or missing:
        raise ValueError(
            f"flax tree does not match the model: unused leaves {unused}, "
            f"unfilled parameters {missing}"
        )
    with torch.no_grad():
        for key, arr in values.items():
            state[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return model
