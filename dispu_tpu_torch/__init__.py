"""dispu_tpu_torch — the Dis-PU upsampler in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``dispu_tpu``, which stays beside it as the
reference.  Same layout (``config``, ``ops/``, ``nn/``, ``models/``,
``inference``, ``serving``, ``losses``, ``data/``, ``train/``,
``evaluation/``, ``utils/``), PyTorch idiom, and the JAX package's (b, n,
c) layout at every public function.  It serves whole-cloud upsampling
(``inference.PatchUpsampler``, or an exported artifact through
``serving.ServedUpsampler``), trains the generator on the CD losses
(``train.trainer.Trainer``) and scores outputs (``evaluation``, ``python
-m dispu_tpu_torch.evaluate``).  The Pallas kernels of those paths are
CUDA kernels written for ``sm_90a`` under ``kernels/``, built with
``nvcc`` at first use.  Entry points run on the card unless asked for
the CPU.

The names below load on first use, so that a process that only serves an
artifact imports none of the model code.
"""

import importlib

_LAZY = {"GeneratorConfig": "config", "InferenceConfig": "config",
         "PatchUpsampler": "inference", "plan_counts": "inference"}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
