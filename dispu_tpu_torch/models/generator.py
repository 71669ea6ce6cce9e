"""The Dis-PU generator (counterpart of ``models/generator.py``).

(b, n, 3) patch → (coarse, fine), each (b, r·n, 3):
  dense generator: FeatureExtractorGCN → DuplicateUp × num_up_steps →
    CoordinateRegressor ('coarse');
  spatial refiner: PointShuffle2 → CoordinateRegressor(offset);
    fine = coarse + offset.
Submodule names are the flax scope names, so a flax tree converts by path
(``convert.from_flax_variables``).  The forward's spans (``utils.tracing``):
``gen.extract`` (the coarse extractor), ``gen.expand`` (the up steps and
the coarse regressor), ``gen.refine`` (the refiner).
"""

from __future__ import annotations

import torch
from torch import nn

from dispu_tpu_torch.config import GeneratorConfig, check_supported
from dispu_tpu_torch.nn.edgeconv import FeatureExtractorGCN
from dispu_tpu_torch.nn.layers import init_weights, set_compute_dtype
from dispu_tpu_torch.nn.refine import PointShuffle2
from dispu_tpu_torch.nn.upsample import CoordinateRegressor, DuplicateUp
from dispu_tpu_torch.utils.tracing import span


def _gather_impl(cfg: GeneratorConfig, fast: bool) -> str:
    """The gather of the backbone (``fast`` = ``fast_gather_backbone``) or
    of the refiner (``fast`` = ``fast_gather``), as the JAX package maps
    the configuration: the fused kernel with ``fused_grouping`` (bf16
    features when ``fast``), else the bf16 'onehot' gather when ``fast``,
    else ``gather_impl``."""
    if cfg.fused_grouping:
        return "fused_turbo" if fast else "fused"
    return "onehot" if fast else cfg.gather_impl


class DisPUGenerator(nn.Module):
    """Dis-PU generator.  It is made in ``.eval()`` mode (batch norm on its
    running statistics); ``.train()`` switches batch norm to the batch's
    statistics, as the train step does.

    The turbo flags (``fast_knn``, ``fast_gather``,
    ``fast_gather_backbone``, ``fused_grouping``, ``dense_impl='split'``)
    and ``refine_local_impl`` reach the modules as the JAX package's
    generator passes them.

    impl: how the kNN and attention kernels are reached — 'auto' (the
    kernels for CUDA tensors, their plain versions for CPU tensors),
    'cuda' or 'torch' (see ``dispu_tpu_torch.kernels``).  Weights are
    glorot-uniform with zero biases, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed``, so a seed gives the same
    weights on every machine.

    dtype: the compute dtype, the flax module's ``dtype`` ('float32' or
    'bfloat16'; ``nn.layers.set_compute_dtype`` changes it later).  The
    parameters stay f32 at either, and the geometry keeps the inputs'
    dtype (f32): ``coarse`` and the refiner's offset come back in it, and
    the refiner's xyz kNN and grouping take those coordinates.
    """

    def __init__(self, cfg: GeneratorConfig = GeneratorConfig(),
                 impl: str = "auto", seed: int = 0, dtype="float32"):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        kw = dict(use_bn=cfg.use_bn, bn_momentum=cfg.bn_momentum, impl=impl)
        knn_variant = "packed" if cfg.fast_knn else "auto"
        self.feature_extraction_coarse = FeatureExtractorGCN(
            3, cfg.growth_rate, cfg.dense_block, cfg.dense_n, cfg.knn,
            gather_impl=_gather_impl(cfg, cfg.fast_gather_backbone),
            knn_variant=knn_variant, dense_impl=cfg.dense_impl, **kw)
        width = self.feature_extraction_coarse.out_features
        for i in range(cfg.num_up_steps):
            up = DuplicateUp(width, up_ratio=cfg.step_ratio)
            self.add_module(f"upshuffle_{i}", up)
            width = up.out_features
        self.coarse_coordinate_regressor = CoordinateRegressor(width)
        if cfg.refine:
            if cfg.fine_extractor:
                # the JAX package gives it the default exact gather and
                # selection, and the configured dense_impl
                self.feature_extraction_fine = FeatureExtractorGCN(
                    3, cfg.growth_rate, 2, cfg.dense_n, cfg.knn,
                    dense_impl=cfg.dense_impl, **kw)
                width += self.feature_extraction_fine.out_features
            self.PointShuffle = PointShuffle2(
                width, nsample=cfg.refine_nsample, mlp=tuple(cfg.refine_mlp),
                use_nonlocal=cfg.use_nonlocal, use_local=cfg.use_local,
                gather_impl=_gather_impl(cfg, cfg.fast_gather),
                knn_variant=knn_variant, local_impl=cfg.refine_local_impl,
                **kw)
            self.fine_coordinate_regressor = CoordinateRegressor(
                cfg.refine_mlp[-1],
                offset_range=cfg.offset_range if cfg.is_off else None)
        init_weights(self, torch.Generator().manual_seed(seed))
        set_compute_dtype(self, dtype)
        self.eval()

    def forward(self, inputs: torch.Tensor):
        cfg = self.cfg
        with span("gen.extract"):
            feat = self.feature_extraction_coarse(inputs)
        with span("gen.expand"):
            for i in range(cfg.num_up_steps):
                feat = getattr(self, f"upshuffle_{i}")(feat)
            # xyz flows in the inputs' dtype (f32) at any compute dtype, as
            # in the JAX package
            coarse = self.coarse_coordinate_regressor(feat).to(inputs.dtype)
        if not cfg.refine:
            return coarse, coarse
        with span("gen.refine"):
            fine_feat = feat
            if cfg.fine_extractor:
                extra = self.feature_extraction_fine(coarse)
                fine_feat = torch.cat([extra, fine_feat], dim=-1)
            new_coarse, fine_feat = self.PointShuffle(coarse, fine_feat)
            offset = self.fine_coordinate_regressor(fine_feat).to(
                inputs.dtype)
            fine = new_coarse + offset if cfg.is_off else offset
        return coarse, fine
