"""Load a flax variable tree, or a whole JAX training state (CD or GAN),
into the port.

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


def _collect(tree, what: str, targets: Dict[str, torch.Tensor],
             unused: list) -> Dict[str, np.ndarray]:
    """The leaves of a flax tree as {target key: array}, transposed where
    the key is a dense weight; leaves that map to no target go to
    ``unused``; a shape that does not fit raises ``ValueError``."""
    values = {}
    for path, leaf in _leaves(tree):
        key, transpose = _torch_key(path)
        if key not in targets:
            unused.append(f"{what}/{'/'.join(path)}")
            continue
        arr = np.asarray(leaf, np.float32)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(targets[key].shape):
            raise ValueError(
                f"{what}/{'/'.join(path)}: shape {arr.shape} does not fit "
                f"{key} {tuple(targets[key].shape)}"
            )
        values[key] = arr
    return values


def _fill(targets: Dict[str, torch.Tensor], values: Dict[str, np.ndarray],
          unused: list, what: str) -> None:
    """Copy ``values`` into ``targets``, or raise ``ValueError`` when a
    leaf was left over or a target left unfilled."""
    missing = sorted(set(targets) - set(values))
    if unused or missing:
        raise ValueError(
            f"{what} does not match the model: unused leaves {unused}, "
            f"unfilled parameters {missing}"
        )
    with torch.no_grad():
        for key, arr in values.items():
            targets[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))


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
        values.update(_collect(variables[collection], collection, state,
                               unused))
    _fill(state, values, unused, "flax tree")
    return model


def _field(obj, name: str):
    return obj[name] if hasattr(obj, "keys") else getattr(obj, name)


def from_jax_state(state, jax_state):
    """Fill a ``train.state.GeneratorState`` from the JAX package's
    ``GeneratorState`` (or any object or mapping with its fields as numpy
    leaves): ``params`` and ``batch_stats`` into the model, ``opt_state``'s
    ``mu``, ``nu`` and ``count`` into the Adam moments, and ``epoch`` and
    ``step``.  Raises ``ValueError`` on a leaf that maps to nothing, a
    shape that differs, or a tensor left unfilled."""
    from_flax_variables(state.model, {
        "params": _field(jax_state, "params"),
        "batch_stats": _field(jax_state, "batch_stats"),
    })
    opt = _field(jax_state, "opt_state")
    for name, target in (("mu", state.mu), ("nu", state.nu)):
        unused = []
        what = f"opt_state/{name}"
        _fill(target, _collect(_field(opt, name), what, target, unused),
              unused, what)
    state.count = int(np.asarray(_field(opt, "count")))
    state.epoch = float(np.asarray(_field(jax_state, "epoch")))
    state.step = int(np.asarray(_field(jax_state, "step")))
    return state


def from_jax_gan_state(state, jax_state):
    """Fill a ``train.gan_steps.GANState`` from the JAX package's
    ``GANState`` (or any object or mapping with its fields): the generator
    half through :func:`from_jax_state`, the critic's ``d_params`` into
    the critic, and ``d_opt_state``'s ``mu``, ``nu`` and ``count`` into
    its Adam moments.  Raises ``ValueError`` as :func:`from_jax_state`
    does."""
    from_jax_state(state.gen, _field(jax_state, "gen"))
    from_flax_variables(state.disc, {"params": _field(jax_state, "d_params")})
    opt = _field(jax_state, "d_opt_state")
    for name, target in (("mu", state.d_mu), ("nu", state.d_nu)):
        unused = []
        what = f"d_opt_state/{name}"
        _fill(target, _collect(_field(opt, name), what, target, unused),
              unused, what)
    state.d_count = int(np.asarray(_field(opt, "count")))
    return state
