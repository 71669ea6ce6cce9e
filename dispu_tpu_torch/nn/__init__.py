"""nn modules of the port: the JAX package's ``nn`` exports."""

from dispu_tpu_torch.nn.layers import PointConv, PointMLP, WeightNetHidden
from dispu_tpu_torch.nn.edgeconv import (
    edge_feature,
    DenseEdgeBlock,
    EdgeConv,
    FeatureExtractorGCN,
)
from dispu_tpu_torch.nn.attention import (
    PointNonLocalCell,
    SampleWeights,
    AttentionUnit,
    adaptive_sampling,
)
from dispu_tpu_torch.nn.upsample import DuplicateUp, CoordinateRegressor
from dispu_tpu_torch.nn.refine import PointShuffle2

__all__ = [
    "PointConv",
    "PointMLP",
    "WeightNetHidden",
    "edge_feature",
    "DenseEdgeBlock",
    "EdgeConv",
    "FeatureExtractorGCN",
    "PointNonLocalCell",
    "SampleWeights",
    "AttentionUnit",
    "adaptive_sampling",
    "DuplicateUp",
    "CoordinateRegressor",
    "PointShuffle2",
]
