"""Command line of the port: train or test the Dis-PU generator on the card.

The twin of ``dispu.py``: the same flags and the same ``build_config``,
so one command line gives the same configuration in both packages.
``--turbo true`` applies to the test and export phases only, as there:
bf16 gathers, the packed-key kNN selection, the fused kNN + gather
kernel, the part-split dense EdgeConv and the bucketed merge FPS.
``--device`` (default ``cuda``) is the port's own; ``--device cpu`` runs
the kernels' plain versions.  ``--use_gan true`` trains the generator
against the PointNet++ critic (``GANTrainer``); the test phase restores
the generator of a CD or a GAN checkpoint alike.

    python -m dispu_tpu_torch.cli --phase train --synthetic 84 --epochs 2
    python -m dispu_tpu_torch.cli --phase train --use_gan true \\
        --synthetic 84 --epochs 2 --d_clip 0
    python -m dispu_tpu_torch.cli --phase test --log_dir log \\
        --test_data 'demo/gt/*.xyz' --turbo true --out_folder outputs

Not ported (``NotImplementedError``, naming the ROADMAP.md item):
``--phase export`` (``serving.py``).
"""

from __future__ import annotations

import argparse
import logging
import os
from glob import glob


def str2bool(x: str) -> bool:
    return str(x).lower() in ("true", "1", "yes")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--phase", default="train",
                   choices=["train", "test", "export"])
    p.add_argument("--log_dir", default="log")
    p.add_argument("--data_dir", default="data")
    p.add_argument("--test_data", default="data/test/*.xyz")
    p.add_argument("--out_folder", default=None)
    p.add_argument("--augment", type=str2bool, default=True)
    p.add_argument("--restore", action="store_true")
    p.add_argument("--more_up", type=int, default=0,
                   help="declared by the reference, unused there and here")
    p.add_argument("--training_epoch", type=int, default=401)
    p.add_argument("--batch_size", type=int, default=28)
    p.add_argument("--random", type=str2bool, default=True)
    p.add_argument("--jitter", type=str2bool, default=False,
                   help="declared by the reference, unused there and here")
    p.add_argument("--jitter_sigma", type=float, default=0.01)
    p.add_argument("--jitter_max", type=float, default=0.03)
    p.add_argument("--cluster_prob", type=float, default=0.0)
    p.add_argument("--cluster_size", type=int, default=4)
    p.add_argument("--up_ratio", type=int, default=4)
    p.add_argument("--final_ratio", type=int, default=4, help="[4,16]")
    p.add_argument("--patch_num_point", type=int, default=256)
    p.add_argument("--patch_num_ratio", type=int, default=3)
    p.add_argument("--base_lr_d", type=float, default=1e-4)
    p.add_argument("--base_lr_g", type=float, default=1e-3)
    p.add_argument("--beta", type=float, default=0.9)
    p.add_argument("--lr_decay", type=str2bool, default=True)
    p.add_argument("--decay_step", type=int, default=30)
    p.add_argument("--start_decay_step", type=int, default=40,
                   help="declared by the reference, unused there and here")
    p.add_argument("--lr_decay_steps", type=int, default=40,
                   help="declared by the reference, unused there and here")
    p.add_argument("--lr_decay_rate", type=float, default=0.7)
    p.add_argument("--lr_clip", type=float, default=1e-6)
    p.add_argument("--steps_per_print", type=int, default=50)
    p.add_argument("--visulize", type=str2bool, default=False,
                   help="periodic 3-view renders (the reference's spelling)")
    p.add_argument("--steps_per_visu", type=int, default=100)
    p.add_argument("--epoch_per_save", type=int, default=20)
    p.add_argument("--use_repulse", type=str2bool, default=True)
    p.add_argument("--repulsion_w", type=float, default=1.0)
    p.add_argument("--fidelity_w", type=float, default=100.0)
    p.add_argument("--uniform_w", type=float, default=10.0)
    p.add_argument("--gan_w", type=float, default=1.0)
    p.add_argument("--gen_update", type=int, default=2)
    p.add_argument("--use_gan", type=str2bool, default=False)
    p.add_argument("--d_clip", type=float, default=0.01)
    p.add_argument("--fake_pool_size", type=int, default=0)
    p.add_argument("--patch_batch", type=int, default=32)
    p.add_argument("--stream_batch", type=int, default=1,
                   help="test phase: upsample this many same-size clouds "
                        "per upsample_many call (1 = one cloud a call)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N procedural patches when no h5 dataset "
                        "is present")
    p.add_argument("--epochs", type=int, default=None,
                   help="override training_epoch (smoke runs)")
    p.add_argument("--export_sizes", type=int, nargs="+", default=None,
                   help="export phase (not ported)")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 is not ported and raises")
    p.add_argument("--compile_cache", default=None, metavar="DIR",
                   help="dispu.py's XLA cache; the port compiles no "
                        "programs, so it has no effect here")
    p.add_argument("--turbo", type=str2bool, default=False,
                   help="test/export phases: the turbo serving flags (bf16 "
                        "gathers, packed-key kNN, fused kNN+gather kernel, "
                        "part-split dense EdgeConv, bucketed merge FPS); "
                        "ignored for training")
    p.add_argument("--dense_impl", default="concat",
                   choices=["concat", "split"])
    p.add_argument("--device", default="cuda",
                   help="the port's own flag: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_config(args):
    """The ``ExperimentConfig`` of a command line, field for field as
    ``dispu.py``'s ``build_config``."""
    from dispu_tpu_torch.config import (DataConfig, ExperimentConfig,
                                        GeneratorConfig, InferenceConfig,
                                        LossConfig, TrainConfig)

    turbo = bool(args.turbo) and args.phase in ("test", "export")
    return ExperimentConfig(
        generator=GeneratorConfig(
            up_ratio=args.up_ratio, num_points=args.patch_num_point,
            dense_impl="split" if turbo else args.dense_impl,
            fast_gather=turbo, fast_gather_backbone=turbo,
            fast_knn=turbo, fused_grouping=turbo,
        ),
        loss=LossConfig(
            use_repulsion=args.use_repulse, repulsion_w=args.repulsion_w,
            fidelity_w=args.fidelity_w, uniform_w=args.uniform_w,
            gan_w=args.gan_w,
        ),
        train=TrainConfig(
            batch_size=args.batch_size, training_epoch=args.training_epoch,
            base_lr_g=args.base_lr_g, base_lr_d=args.base_lr_d,
            beta1=args.beta, lr_decay=args.lr_decay,
            decay_step_epochs=args.decay_step,
            lr_decay_rate=args.lr_decay_rate, lr_clip=args.lr_clip,
            epoch_per_save=args.epoch_per_save,
            steps_per_print=args.steps_per_print, visualize=args.visulize,
            steps_per_visu=args.steps_per_visu, gen_update=args.gen_update,
            d_clip=args.d_clip, fake_pool_size=args.fake_pool_size,
            seed=args.seed, compute_dtype=args.compute_dtype,
        ),
        data=DataConfig(
            data_dir=args.data_dir, num_point=args.patch_num_point,
            up_ratio=args.up_ratio, random_input=args.random,
            cluster_prob=args.cluster_prob, cluster_size=args.cluster_size,
            augment=args.augment, jitter_sigma=args.jitter_sigma,
            jitter_max=args.jitter_max,
        ),
        inference=InferenceConfig(
            final_ratio=args.final_ratio,
            patch_num_point=args.patch_num_point,
            patch_num_ratio=args.patch_num_ratio,
            patch_batch=args.patch_batch, compute_dtype=args.compute_dtype,
            merge_fps="bucketed" if turbo else "exact",
        ),
        use_gan=args.use_gan,
        log_dir=args.log_dir,
    )


def run_train(args, cfg):
    from dispu_tpu_torch.data.dataset import PatchDataset
    from dispu_tpu_torch.train.gan_trainer import GANTrainer
    from dispu_tpu_torch.train.trainer import Trainer

    dataset = None
    if args.synthetic:
        dataset = PatchDataset(
            h5_path=cfg.data.h5_path, num_point=cfg.data.num_point,
            up_ratio=cfg.data.up_ratio,
            synthetic_patches_count=args.synthetic, seed=args.seed)
    trainer = GANTrainer if cfg.use_gan else Trainer
    return trainer(cfg, dataset=dataset, device=args.device).train(
        restore=args.restore, epochs=args.epochs)


def restore_generator_weights(cfg, device):
    """The generator's ``state_dict`` from the newest checkpoint in the log
    dir (``model-<epoch>.pt``, written by the port's ``Trainer``, or by
    its ``GANTrainer``, whose generator half is taken)."""
    import torch

    from dispu_tpu_torch.utils.checkpoint import latest_checkpoint

    epoch, path = latest_checkpoint(cfg.log_dir)
    if path is None:
        raise SystemExit(f"no checkpoint found in {cfg.log_dir}")
    logging.info("restoring %s (epoch %d)", path, epoch)
    saved = torch.load(path, map_location=device, weights_only=True)
    if "model" in saved:
        return saved["model"]
    if "model" not in saved.get("gen", {}):
        raise ValueError(f"{path} holds neither a CD training state nor a "
                         "GAN checkpoint's generator half")
    logging.info("restored the generator half of a GAN checkpoint")
    return saved["gen"]["model"]


def run_test(args, cfg):
    """Whole-cloud upsampling of every file of the ``--test_data`` glob
    into ``<out_folder>/<name>_X{final_ratio}.xyz``; with ``--stream_batch``
    > 1, same-size clouds go through ``upsample_many`` together."""
    import numpy as np

    from dispu_tpu_torch.evaluation.meshio import read_xyz, write_xyz
    from dispu_tpu_torch.inference import PatchUpsampler

    upsampler = PatchUpsampler(gen_cfg=cfg.generator, inf_cfg=cfg.inference,
                               device=args.device, seed=args.seed)
    upsampler.model.load_state_dict(
        restore_generator_weights(cfg, upsampler.device))
    out_folder = args.out_folder or os.path.join(cfg.log_dir, "outputs")
    os.makedirs(out_folder, exist_ok=True)

    def write_out(name, out):
        out_path = os.path.join(
            out_folder, f"{name}_X{cfg.inference.final_ratio}.xyz")
        write_xyz(out_path, out)
        logging.info("wrote %s (%d points)", out_path, len(out))

    by_size = {}
    for point_path in sorted(glob(args.test_data)):
        pc = read_xyz(point_path)[:, :3]
        by_size.setdefault(len(pc), []).append(
            (os.path.basename(point_path)[:-4], pc))
    step = max(1, args.stream_batch)
    for size, items in sorted(by_size.items()):
        for i in range(0, len(items), step):
            chunk = items[i:i + step]
            if len(chunk) == 1:
                write_out(chunk[0][0], upsampler.upsample(chunk[0][1]))
                continue
            logging.info("streaming %d clouds of %d points", len(chunk), size)
            outs = upsampler.upsample_many(np.stack([pc for _, pc in chunk]))
            for (name, _), out in zip(chunk, outs):
                write_out(name, out)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    cfg = build_config(args)
    if args.phase == "export":
        raise NotImplementedError(
            "--phase export is not ported yet (ROADMAP.md, queue 1: "
            "serving.py)")
    if args.phase == "train":
        run_train(args, cfg)
    else:
        run_test(args, cfg)


if __name__ == "__main__":
    main()
