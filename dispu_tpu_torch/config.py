"""Typed configuration of the generator and of whole-cloud inference.

A copy of ``GeneratorConfig`` and ``InferenceConfig`` from the JAX
package's ``config.py`` (same fields, same defaults), kept here so that the
port imports nothing of that package.  Field comments that describe TPU
measurements stay with the JAX copy; settings that this port does not run
yet raise ``NotImplementedError`` through :func:`check_supported`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """Architecture of the Dis-PU generator (dense generator + refiner)."""

    up_ratio: int = 4            # r: points out = r * points in
    step_ratio: int = 4          # per-pass ratio; 16x = two chained 4x passes
    num_points: int = 256        # patch size at train time
    dense_block: int = 4         # GCN dense blocks (growth path 24→480)
    growth_rate: int = 24        # 'filter'
    dense_n: int = 3             # edge-conv layers per dense block
    knn: int = 16                # K for feature-space edge conv
    refine: bool = True          # enable the spatial refiner
    fine_extractor: bool = False # extra GCN on coarse points
    is_off: bool = True          # refiner regresses a bounded offset
    refine_nsample: int = 16     # K for the refiner's xyz kNN
    refine_mlp: Tuple[int, ...] = (128, 128, 256)
    offset_range: float = 0.5    # sigmoid offset range
    use_bn: bool = False
    bn_momentum: float = 0.95    # flax convention ('bn_decay')
    use_nonlocal: bool = True    # NL attention cell in refiner
    use_local: bool = True       # local weighted pooling in refiner
    fast_gather: bool = False           # turbo: bf16 refiner gathers
    fast_gather_backbone: bool = False  # turbo: bf16 backbone gathers
    fast_knn: bool = False              # turbo: packed-key kNN selection
    # exact neighborhood gather; every exact choice is a plain index
    # gather here ('gather', 'onehot_hp', 'onehot3', 'pallas')
    gather_impl: str = "onehot_hp"
    fused_grouping: bool = False        # fused kNN+gather kernel (opt-in)
    refine_local_impl: str = "xla"      # 'xla' | 'fused' | 'megafused'
    dense_impl: str = "concat"          # 'concat' | 'split'

    @property
    def num_out_points(self) -> int:
        return self.num_points * self.up_ratio

    @property
    def num_up_steps(self) -> int:
        return max(1, round(self.up_ratio ** (1.0 / self.step_ratio)))


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Whole-cloud patch inference."""

    final_ratio: int = 4         # 4 or 16
    step_ratio: int = 4
    patch_num_point: int = 256
    patch_num_ratio: int = 3     # seeds = N / patch_size * ratio
    patch_batch: int = 32        # patches per generator call
    merge_fps: str = "exact"     # 'exact' | 'bucketed'
    merge_fps_buckets: int = 64
    merge_fps_rank: str = "argsort"
    compute_dtype: str = "float32"


EXACT_GATHERS = ("gather", "onehot_hp", "onehot3", "pallas")


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: {item})"
    )


def check_supported(gen_cfg: GeneratorConfig,
                    inf_cfg: InferenceConfig | None = None) -> None:
    """Raise ``NotImplementedError`` for settings outside the ported slice.

    Each message names the ROADMAP.md queue item that will bring it.
    """
    turbo = "turbo and opt-in paths"
    if gen_cfg.fast_knn:
        _unsupported("fast_knn (packed-key kNN)", turbo)
    if gen_cfg.fast_gather or gen_cfg.fast_gather_backbone:
        _unsupported("fast_gather / fast_gather_backbone", turbo)
    if gen_cfg.fused_grouping:
        _unsupported("fused_grouping", turbo)
    if gen_cfg.refine_local_impl != "xla":
        _unsupported(f"refine_local_impl={gen_cfg.refine_local_impl!r}", turbo)
    if gen_cfg.dense_impl != "concat":
        _unsupported(f"dense_impl={gen_cfg.dense_impl!r}", turbo)
    if gen_cfg.gather_impl not in EXACT_GATHERS:
        _unsupported(f"gather_impl={gen_cfg.gather_impl!r}", turbo)
    if inf_cfg is None:
        return
    if inf_cfg.compute_dtype != "float32":
        _unsupported(f"compute_dtype={inf_cfg.compute_dtype!r}", turbo)
    if inf_cfg.merge_fps != "exact":
        _unsupported(f"merge_fps={inf_cfg.merge_fps!r}", turbo)
