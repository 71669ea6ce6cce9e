"""dispu_tpu_torch — the Dis-PU upsampler in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``dispu_tpu``, which stays beside it as the
reference.  Same layout (``config``, ``ops/``, ``nn/``, ``models/``,
``inference``, ``losses``, ``data/``, ``train/``, ``utils/``), PyTorch
idiom, and the JAX package's (b, n, c) layout at every public function.
It serves whole-cloud upsampling (``inference.PatchUpsampler``) and trains
the generator on the CD losses (``train.trainer.Trainer``).  The Pallas
kernels of those paths are CUDA kernels written for ``sm_90a`` under
``kernels/``, built with ``nvcc`` at first use.  Entry points run on the
card unless asked for the CPU.
"""

from dispu_tpu_torch.config import GeneratorConfig, InferenceConfig
from dispu_tpu_torch.inference import PatchUpsampler, plan_counts

__all__ = ["GeneratorConfig", "InferenceConfig", "PatchUpsampler",
           "plan_counts"]
