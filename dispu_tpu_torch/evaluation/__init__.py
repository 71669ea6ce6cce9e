"""Evaluation stack (counterpart of ``evaluation/``): CD/HD and the
point-to-face distance on the card, the geodesic-disk uniformity on the
host, the evaluation.csv report, and mesh and point-cloud files."""

from dispu_tpu_torch.evaluation.meshio import read_off, read_xyz, write_xyz
from dispu_tpu_torch.evaluation.metrics import (
    cd_hd,
    geodesic_distances,
    point_to_mesh_distance,
    uniformity_measure,
)
from dispu_tpu_torch.evaluation.report import evaluate_dirs

__all__ = [
    "read_off",
    "read_xyz",
    "write_xyz",
    "cd_hd",
    "geodesic_distances",
    "point_to_mesh_distance",
    "uniformity_measure",
    "evaluate_dirs",
]
