"""Typed configuration of the generator, training and whole-cloud inference.

A copy of the JAX package's ``config.py`` dataclasses (same fields, same
defaults), kept here so that the port imports nothing of that package.
Field comments that describe TPU measurements stay with the JAX copy;
settings that this port does not run yet raise ``NotImplementedError``
through :func:`check_supported` and :func:`check_train_supported`.
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
    # exact neighborhood gather: 'pallas' runs the gather kernel and its
    # scatter-add backward; 'gather', 'onehot_hp', 'onehot3' are a plain
    # index gather here
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


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    """PointNet++-MSG patch critic (``models/discriminator.py``)."""

    divide_ratio: int = 2
    knn: bool = True
    downsample_ratio: int = 8
    radius_list: Tuple[float, ...] = (0.1, 0.2, 0.4)
    fused_grouping: bool = False

    @property
    def nsample_list(self) -> Tuple[int, ...]:
        return (8, 16, 24) if self.knn else (16, 32, 64)

    @property
    def mlp_lists(self) -> Tuple[Tuple[int, ...], ...]:
        d = self.divide_ratio
        return (
            (32 // d, 32 // d, 64 // d),
            (64 // d, 64 // d, 128 // d),
            (64 // d, 96 // d, 128 // d),
        )


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights and schedules."""

    coarse_cd_w: float = 1000.0
    fine_cd_w: float = 1000.0
    hd_w: float = 100.0          # tracked metric, not in the total
    use_repulsion: bool = True
    repulsion_w: float = 1.0
    repulsion_nsample: int = 20
    repulsion_radius: float = 0.07
    repulsion_h: float = 0.001
    uniform_w: float = 0.0
    fidelity_w: float = 100.0
    gan_w: float = 1.0
    # weight_fine piecewise schedule: epochs [10,20,30] → [0.01,0.1,0.5,1.0]
    weight_fine_boundaries: Tuple[float, ...] = (10.0, 20.0, 30.0)
    weight_fine_values: Tuple[float, ...] = (0.01, 0.1, 0.5, 1.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule.

    ``donate_state``, ``device_data``, ``device_data_max_bytes`` and
    ``scan_steps`` say how the JAX package dispatches steps to its device;
    they are accepted here and change nothing: the port always runs one
    step at a time with the whole patch set resident on the step's device.
    """

    batch_size: int = 28
    training_epoch: int = 401
    base_lr_g: float = 1e-3
    base_lr_d: float = 1e-4
    d_clip: float = 0.01
    fake_pool_size: int = 0
    beta1: float = 0.9
    lr_decay: bool = True
    decay_step_epochs: int = 30
    lr_decay_rate: float = 0.7
    lr_clip: float = 1e-6
    epoch_per_save: int = 20
    steps_per_print: int = 50
    visualize: bool = False
    steps_per_visu: int = 100
    profile: bool = False
    backup_sources: bool = True
    gen_update: int = 2
    seed: int = 0
    donate_state: bool = True
    compute_dtype: str = "float32"
    remat: bool = False
    device_data: bool = True
    device_data_max_bytes: int = 2_000_000_000
    scan_steps: bool = True


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset and augmentation."""

    data_dir: str = "data"
    num_point: int = 256
    up_ratio: int = 4
    random_input: bool = True    # nonuniform re-sample of the input from gt
    cluster_prob: float = 0.0    # share of examples drawn as seed clusters
    cluster_size: int = 4
    augment: bool = True
    jitter: bool = False
    jitter_sigma: float = 0.01
    jitter_max: float = 0.03
    scale_low: float = 0.8
    scale_high: float = 1.2

    @property
    def h5_path(self) -> str:
        import os

        return os.path.join(
            self.data_dir,
            "PUGAN_poisson_%d_poisson_%d.h5"
            % (self.num_point, self.num_point * self.up_ratio),
        )


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (multi-device runs are not ported)."""

    data_axis: str = "data"
    num_devices: int = 0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    generator: GeneratorConfig = GeneratorConfig()
    discriminator: DiscriminatorConfig = DiscriminatorConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    data: DataConfig = DataConfig()
    inference: InferenceConfig = InferenceConfig()
    mesh: MeshConfig = MeshConfig()
    use_gan: bool = False
    log_dir: str = "log"


EXACT_GATHERS = ("gather", "onehot_hp", "onehot3", "pallas")
#: every gather_impl the port runs: the exact ones, the bf16 turbo gather
#: and the fused kNN + gather kernel (exact or bf16 features)
GATHERS = EXACT_GATHERS + ("onehot", "fused", "fused_turbo")


def _unsupported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1: {item})"
    )


def check_supported(gen_cfg: GeneratorConfig,
                    inf_cfg: InferenceConfig | None = None) -> None:
    """Raise ``NotImplementedError`` for settings outside the ported slice
    (``ValueError`` for values the JAX package does not know either).

    Each message names the ROADMAP.md queue item that will bring it.  The
    turbo serving flags are ported: ``fast_knn``, ``fast_gather``,
    ``fast_gather_backbone``, ``fused_grouping``, ``dense_impl='split'``,
    ``gather_impl='onehot'`` and the bucketed merge with the argsort rank.
    """
    turbo = "turbo and opt-in paths"
    if gen_cfg.refine_local_impl != "xla":
        _unsupported(f"refine_local_impl={gen_cfg.refine_local_impl!r} "
                     "(queue 2 items 12 and 13)", turbo)
    if gen_cfg.dense_impl not in ("concat", "split"):
        raise ValueError(f"unknown dense_impl {gen_cfg.dense_impl!r}")
    if gen_cfg.gather_impl not in GATHERS:
        _unsupported(f"gather_impl={gen_cfg.gather_impl!r}", turbo)
    if inf_cfg is None:
        return
    if inf_cfg.compute_dtype != "float32":
        _unsupported(f"compute_dtype={inf_cfg.compute_dtype!r}", turbo)
    if inf_cfg.merge_fps not in ("exact", "bucketed"):
        raise ValueError(f"unknown merge_fps {inf_cfg.merge_fps!r}")
    if inf_cfg.merge_fps_rank not in ("argsort", "radix"):
        raise ValueError(f"unknown merge_fps_rank {inf_cfg.merge_fps_rank!r}")
    if inf_cfg.merge_fps == "bucketed" and inf_cfg.merge_fps_rank == "radix":
        _unsupported("merge_fps_rank='radix' (morton_rank)",
                     "ops/sampling.py, the rest (item 12)")


def check_train_supported(cfg: ExperimentConfig) -> None:
    """Raise ``NotImplementedError`` for training settings outside the
    ported slice, naming the ROADMAP.md queue item that will bring each.

    Ported: CD and GAN training (``use_gan``, ``fake_pool_size``) on one
    device in f32, with any exact ``gather_impl`` ('pallas' through the
    gather and scatter-add kernels) or with ``fused_grouping`` alone (the
    ``knn_group`` kernel and its backward rule), for the generator and
    the critic.  The other turbo flags serve only."""
    check_supported(cfg.generator)
    g, turbo = cfg.generator, "turbo and opt-in paths"
    if g.fast_knn:
        _unsupported("training with fast_knn (packed-key kNN)", turbo)
    if g.fast_gather or g.fast_gather_backbone:
        _unsupported("training with fast_gather / fast_gather_backbone",
                     turbo)
    if g.dense_impl != "concat":
        _unsupported(f"training with dense_impl={g.dense_impl!r}", turbo)
    if g.gather_impl not in EXACT_GATHERS:
        _unsupported(f"training with gather_impl={g.gather_impl!r}", turbo)
    if cfg.train.remat:
        _unsupported("remat", turbo)
    if cfg.train.compute_dtype != "float32":
        _unsupported(f"compute_dtype={cfg.train.compute_dtype!r}", turbo)
    host = "host-side utilities"
    if cfg.train.visualize:
        _unsupported("visualize (training renders)", host)
    if cfg.train.profile:
        _unsupported("profile (the trainer's trace of its first epoch)", host)
    if cfg.mesh.num_devices > 1:
        _unsupported("a device mesh", "multi-GPU runs")
