"""The reference's TF1 checkpoint → the port's generator ``state_dict``
(counterpart of ``utils/convert_tf_checkpoint.py``).

:func:`map_tf_name` maps each TF variable of the reference's generator
onto the ``state_dict`` key of the port's ``DisPUGenerator`` and
:func:`convert_value` its value onto the port's layout, so no flax tree
lies between them.  Only :func:`convert_checkpoint`, which reads the
file, needs TensorFlow; everything else is numpy.

Scopes (the reference graph's → the port's modules):

  generator/generator/feature_extraction_coarse/layer{k}[_prep]/...
      → feature_extraction_coarse.layer{k}[_prep][.l{i}].dense.*
  generator/generator/upshuffle_0/conv{1,2}/...
  generator/generator/coarse_coordinate_regressor/fc_layer{i}/...
  generator/refine/PointShuffle/{conv0,conv1,skip,after_conv,aggregation}/...
  generator/refine/PointShuffle/PointShuffle/{conv_kv,conv_query,conv_back_project}/...
      → PointShuffle.non_local.*  (the non-local cell re-opens a
                                    'PointShuffle' scope inside the refiner's)
  generator/refine/PointShuffle/weight_net/wconv0/{weights,biases,bn/*}
  generator/refine/fine_coordinate_regressor/fc_layer{i}/...

Layouts: a TF kernel is (1, 1, Cin, Cout) at a 1×1 conv2d, (1, Cin, Cout)
at a conv1d (the ``*_prep`` compressions, both coordinate regressors'
``fc_layer``s, the refiner's ``skip`` and ``aggregation``), and (1, C',
S, Cout) at the refiner's ``after_conv``, which consumes the (C', S)
plane; each flattens C'-major to (Cin, Cout) and is transposed into the
port's (Cout, Cin) weight (``after_conv`` keeps that row order and
permutes when it is applied).  Batch norm's gamma / beta / moving_mean /
moving_variance become ``bn.scale`` / ``bias`` / ``mean`` / ``var``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

_GEN = "generator/generator/"
_REF = "generator/refine/"
_LEAF = {"weights": "dense.weight", "biases": "dense.bias",
         "bn/gamma": "bn.scale", "bn/beta": "bn.bias",
         "bn/moving_mean": "bn.mean", "bn/moving_variance": "bn.var"}
_LEAF_RE = "(weights|biases)"

# (TF name pattern, state_dict key template before the leaf)
_RULES = [
    (_GEN + r"(feature_extraction_coarse)/(layer\d+(?:_prep)?)/" + _LEAF_RE,
     r"\1.\2"),
    (_GEN + r"(feature_extraction_coarse)/(layer\d+)/(l\d+)/" + _LEAF_RE,
     r"\1.\2.\3"),
    (_GEN + r"(upshuffle_\d+)/(conv\d)/" + _LEAF_RE, r"\1.\2"),
    (_GEN + r"(coarse_coordinate_regressor)/(fc_layer\d)/" + _LEAF_RE,
     r"\1.\2"),
    (_REF + r"PointShuffle/PointShuffle/"
     r"(conv_kv|conv_query|conv_back_project)/" + _LEAF_RE,
     r"PointShuffle.non_local.\1"),
    (_REF + r"PointShuffle/(conv\d|skip|after_conv|aggregation)/" + _LEAF_RE,
     r"PointShuffle.\1"),
    (_REF + r"PointShuffle/weight_net/(wconv\d)/"
     r"(weights|biases|bn/gamma|bn/beta|bn/moving_mean|bn/moving_variance)",
     r"PointShuffle.weight_net.\1"),
    (_REF + r"(fine_coordinate_regressor)/(fc_layer\d)/" + _LEAF_RE,
     r"\1.\2"),
]

#: bookkeeping variables of a training checkpoint, skipped
_SKIPPED = ("Adam", "global_step", "epoch", "beta1_power", "beta2_power")
#: the conv1d sites (3-d TF kernels)
_CONV1D_LAYERS = ("skip", "aggregation")


def map_tf_name(tf_name: str) -> Optional[str]:
    """The port's ``state_dict`` key of one TF variable, or None."""
    tf_name = tf_name.split(":")[0]
    for pat, repl in _RULES:
        m = re.fullmatch(pat, tf_name)
        if m:
            return m.expand(repl) + "." + _LEAF[m.group(m.lastindex)]
    return None


def convert_value(tf_name: str, value: np.ndarray) -> np.ndarray:
    """A TF value in the port's layout: a kernel flattened to (Cin, Cout)
    and transposed; anything else as it is."""
    value = np.asarray(value, np.float32)
    if tf_name.split(":")[0].endswith("weights") and value.ndim >= 2:
        return np.ascontiguousarray(value.reshape(-1, value.shape[-1]).T)
    return value


def convert_variables(tensors: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
    """{TF name: array} → the generator's ``state_dict`` (f32 tensors).
    Optimizer slots and step counters are skipped; any other variable that
    maps to nothing raises ``ValueError``."""
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for name, value in tensors.items():
        key = map_tf_name(name)
        if key is None:
            if not any(s in name for s in _SKIPPED):
                unmapped.append(name)
            continue
        out[key] = torch.from_numpy(convert_value(name, value))
    if unmapped:
        raise ValueError(f"unmapped reference variables: {sorted(unmapped)}")
    return out


def expected_tf_names(state_dict, refine_nsample: int) -> Dict[str, tuple]:
    """Every TF variable name of the reference's generator with the shape
    its checkpoint stores, for a port generator's ``state_dict`` (the
    inverse of :func:`map_tf_name` and :func:`convert_value`): to write
    checkpoint-shaped tensors and to check a real checkpoint for
    completeness."""
    inverse = {v: k for k, v in _LEAF.items()}
    out: Dict[str, tuple] = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        leaf = inverse.get(".".join(parts[-2:]))
        if leaf is None:
            raise ValueError(f"unrecognized state_dict key: {key}")
        scope = ["PointShuffle" if p == "non_local" else p
                 for p in parts[:-2]]
        prefix = _REF if scope[0] in ("PointShuffle",
                                      "fine_coordinate_regressor") else _GEN
        shape = tuple(value.shape)
        if leaf == "weights":
            cout, cin = shape
            layer = scope[-1]
            if layer == "after_conv":
                shape = (1, cin // refine_nsample, refine_nsample, cout)
            elif (layer.endswith("_prep") or layer.startswith("fc_layer")
                  or layer in _CONV1D_LAYERS):
                shape = (1, cin, cout)
            else:
                shape = (1, 1, cin, cout)
        out[prefix + "/".join(scope) + "/" + leaf] = shape
    return out


def convert_checkpoint(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """Read a TF1 checkpoint (``tf.train.load_checkpoint``) into the
    generator's ``state_dict``; raises ``ImportError`` where TensorFlow
    does not import (as on the card's machine: convert where it does and
    save the result with ``torch.save``)."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "TensorFlow is required to read TF1 checkpoints; convert "
            "where it is installed and save the state_dict with "
            "torch.save") from e
    reader = tf.train.load_checkpoint(ckpt_path)
    return convert_variables({name: reader.get_tensor(name)
                              for name in reader.get_variable_to_shape_map()})
