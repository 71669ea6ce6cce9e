"""The Dis-PU generator (counterpart of ``models/generator.py``).

(b, n, 3) patch → (coarse, fine), each (b, r·n, 3):
  dense generator: FeatureExtractorGCN → DuplicateUp × num_up_steps →
    CoordinateRegressor ('coarse');
  spatial refiner: PointShuffle2 → CoordinateRegressor(offset);
    fine = coarse + offset.
Submodule names are the flax scope names, so a flax tree converts by path
(``convert.from_flax_variables``).
"""

from __future__ import annotations

import torch
from torch import nn

from dispu_tpu_torch.config import GeneratorConfig, check_supported
from dispu_tpu_torch.nn.edgeconv import FeatureExtractorGCN
from dispu_tpu_torch.nn.layers import init_weights
from dispu_tpu_torch.nn.refine import PointShuffle2
from dispu_tpu_torch.nn.upsample import CoordinateRegressor, DuplicateUp


class DisPUGenerator(nn.Module):
    """Dis-PU generator.  It is made in ``.eval()`` mode (batch norm on its
    running statistics); ``.train()`` switches batch norm to the batch's
    statistics, as the train step does.

    impl: how the kNN and attention kernels are reached — 'auto' (the
    kernels for CUDA tensors, their plain versions for CPU tensors),
    'cuda' or 'torch' (see ``dispu_tpu_torch.kernels``).  Weights are
    glorot-uniform with zero biases, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed``, so a seed gives the same
    weights on every machine.
    """

    def __init__(self, cfg: GeneratorConfig = GeneratorConfig(),
                 impl: str = "auto", seed: int = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        kw = dict(use_bn=cfg.use_bn, bn_momentum=cfg.bn_momentum)
        gkw = dict(gather_impl=cfg.gather_impl, impl=impl, **kw)
        self.feature_extraction_coarse = FeatureExtractorGCN(
            3, cfg.growth_rate, cfg.dense_block, cfg.dense_n, cfg.knn, **gkw)
        width = self.feature_extraction_coarse.out_features
        for i in range(cfg.num_up_steps):
            up = DuplicateUp(width, up_ratio=cfg.step_ratio)
            self.add_module(f"upshuffle_{i}", up)
            width = up.out_features
        self.coarse_coordinate_regressor = CoordinateRegressor(width)
        if cfg.refine:
            if cfg.fine_extractor:
                self.feature_extraction_fine = FeatureExtractorGCN(
                    3, cfg.growth_rate, 2, cfg.dense_n, cfg.knn, **gkw)
                width += self.feature_extraction_fine.out_features
            self.PointShuffle = PointShuffle2(
                width, nsample=cfg.refine_nsample, mlp=tuple(cfg.refine_mlp),
                use_nonlocal=cfg.use_nonlocal, use_local=cfg.use_local,
                **gkw)
            self.fine_coordinate_regressor = CoordinateRegressor(
                cfg.refine_mlp[-1],
                offset_range=cfg.offset_range if cfg.is_off else None)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()

    def forward(self, inputs: torch.Tensor):
        cfg = self.cfg
        feat = self.feature_extraction_coarse(inputs)
        for i in range(cfg.num_up_steps):
            feat = getattr(self, f"upshuffle_{i}")(feat)
        coarse = self.coarse_coordinate_regressor(feat)
        if not cfg.refine:
            return coarse, coarse
        fine_feat = feat
        if cfg.fine_extractor:
            extra = self.feature_extraction_fine(coarse)
            fine_feat = torch.cat([extra, fine_feat], dim=-1)
        new_coarse, fine_feat = self.PointShuffle(coarse, fine_feat)
        offset = self.fine_coordinate_regressor(fine_feat)
        fine = new_coarse + offset if cfg.is_off else offset
        return coarse, fine
