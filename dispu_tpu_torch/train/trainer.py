"""The experiment driver: epoch loop, checkpoints and logs (counterpart of
``train/trainer.py``).

One epoch is ``len(dataset) // batch_size`` full batches, drawn from the
patch set held on the step's device, one step at a time.  ``BaseTrainer``
carries what every driver shares (device-resident batches, the epoch
loop, crash and scheduled checkpoints, logs, meters); :class:`Trainer`
plugs in the CD state, step and log line, and
``train.gan_trainer.GANTrainer`` the GAN ones.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch

from dispu_tpu_torch.config import ExperimentConfig, check_train_supported
from dispu_tpu_torch.data.dataset import PatchDataset
from dispu_tpu_torch.inference import resolve_device
from dispu_tpu_torch.train.state import create_generator_state
from dispu_tpu_torch.train.steps import make_train_step
from dispu_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                              restore_checkpoint,
                                              save_checkpoint)
from dispu_tpu_torch.utils.logging import (MetricsLogger, StepTimer,
                                           backup_sources, dump_args)
from dispu_tpu_torch.utils.meters import AverageMeter


class BaseTrainer:
    """Shared experiment-driver machinery (see the module docstring).

    device: 'cuda' by default (raises without a card); 'cpu' runs the
    kernels' plain versions.  impl: 'auto', 'cuda' or 'torch' for the
    kernels (``dispu_tpu_torch.kernels``).  A ``mesh`` raises: multi-device
    training is not ported.
    """

    #: metric keys averaged into the epoch's log line
    epoch_metric_keys: Sequence[str] = ()

    def __init__(self, cfg: ExperimentConfig,
                 dataset: Optional[PatchDataset] = None, device="cuda",
                 impl: str = "auto", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device training is not ported yet (ROADMAP.md, "
                "queue 1: multi-GPU runs)")
        check_train_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.impl = impl
        self.dataset = dataset or PatchDataset(
            data_dir=cfg.data.data_dir, num_point=cfg.data.num_point,
            up_ratio=cfg.data.up_ratio, random_input=cfg.data.random_input)
        self.train_step = self._make_step()
        self.logger = MetricsLogger(cfg.log_dir)
        dump_args(cfg.log_dir, cfg)
        if cfg.train.backup_sources:
            backup_sources(cfg.log_dir)
        self._gt = self._radius = self._inputs = None

    # ------------------------------------------------------------- hooks

    def _make_step(self):
        raise NotImplementedError

    def _make_state(self):
        raise NotImplementedError

    def _format_epoch(self, epoch: int, meters, minutes: float) -> str:
        raise NotImplementedError

    # ------------------------------------------------------------ shared

    def init_state(self, restore: bool = False):
        """A fresh state, or with ``restore`` the newest checkpoint in the
        log dir; and the epoch to start from."""
        state = self._make_state()
        start_epoch = 0
        if restore:
            epoch, path = latest_checkpoint(self.cfg.log_dir)
            if path is not None:
                state = restore_checkpoint(path, state)
                start_epoch = epoch
        return state, start_epoch

    def train(self, restore: bool = False, epochs: Optional[int] = None):
        """Run the epoch loop up to ``epochs`` (default
        ``training_epoch``).  On an interrupt or an error a checkpoint of
        the last state is written before the error propagates."""
        state, start_epoch = self.init_state(restore)
        self._last_state = state
        try:
            return self._train_loop(state, start_epoch, epochs)
        except BaseException:
            last = self._last_state
            try:
                save_checkpoint(self.cfg.log_dir, last, int(last.epoch))
                self.logger.text(
                    f"crash checkpoint saved at epoch {int(last.epoch)}")
            except OSError as e:  # keep the original error in front
                print(f"crash checkpoint not saved: {e}")
            raise

    def _ensure_device_data(self):
        if self._gt is None:
            self._gt = torch.from_numpy(self.dataset.gt).to(self.device)
            self._radius = torch.from_numpy(self.dataset.radius).to(
                self.device)
            if not self.cfg.data.random_input:
                self._inputs = torch.from_numpy(self.dataset.inputs).to(
                    self.device)

    def _batches(self):
        """(gt, inputs or None, radius) batches of the device-resident
        patch set; ``inputs`` is the curated sparse column when
        ``random_input`` is off."""
        self._ensure_device_data()
        for idx in self.dataset.epoch_indices(self.cfg.train.batch_size):
            idx = torch.from_numpy(idx).to(self.device)
            inputs = None if self._inputs is None else self._inputs[idx]
            yield self._gt[idx], inputs, self._radius[idx]

    def _epoch(self, state, generator, step: int):
        """One epoch, one step at a time; scalars every
        ``steps_per_print`` steps, fetched from the device only then."""
        cfg = self.cfg
        sums, n_metric = None, 0
        for gt, inputs, radius in self._batches():
            if inputs is None:
                state, metrics = self.train_step(state, gt, radius, generator)
            else:
                state, metrics = self.train_step(state, gt, inputs, radius,
                                                 generator)
            self._last_state = state
            step += 1
            self._timer.tick()
            sums = metrics if sums is None else {
                k: sums[k] + metrics[k] for k in sums}
            n_metric += 1
            if step % cfg.train.steps_per_print == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["steps_per_sec"] = self._timer.steps_per_sec
                self.logger.scalars(step, host)
        return state, sums, n_metric, step

    def _train_loop(self, state, start_epoch: int,
                    epochs: Optional[int] = None):
        cfg = self.cfg
        total_epochs = epochs if epochs is not None else \
            cfg.train.training_epoch
        generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + 1)
        best_fine_cd = math.inf
        self._timer = StepTimer()
        step = state.step
        saved_epoch = None
        for epoch_i in range(start_epoch, total_epochs):
            t0 = time.time()
            state, sums, n_metric, step = self._epoch(state, generator, step)
            meters = {k: AverageMeter() for k in self.epoch_metric_keys}
            if sums is not None:
                for k in meters:
                    if k in sums:
                        meters[k].update(float(sums[k]) / n_metric)
            state = state.next_epoch()
            self._last_state = state
            epoch = epoch_i + 1
            self.logger.text(self._format_epoch(
                epoch, meters, (time.time() - t0) / 60.0))
            # on schedule when fine-CD improved, as the reference saves
            if (epoch % cfg.train.epoch_per_save == 0
                    and meters["fine_cd"].avg < best_fine_cd):
                best_fine_cd = meters["fine_cd"].avg
                save_checkpoint(cfg.log_dir, state, epoch)
                saved_epoch = epoch
        if start_epoch < total_epochs and saved_epoch != total_epochs:
            save_checkpoint(cfg.log_dir, state, total_epochs)
        return state


class Trainer(BaseTrainer):
    """CD-path experiment driver."""

    epoch_metric_keys = ("total", "coarse_cd", "fine_cd", "coarse_hd",
                         "fine_hd", "offset_mean")

    def _make_step(self):
        return make_train_step(self.cfg, device=self.device, impl=self.impl)

    def _make_state(self):
        return create_generator_state(self.cfg.generator,
                                      seed=self.cfg.train.seed,
                                      impl=self.impl, device=self.device)

    def _format_epoch(self, epoch, meters, minutes):
        return (
            "epoch %04d g_loss=%.9f coarse_cd=%.9f coarse_hd=%.9f "
            "fine_cd=%.9f fine_hd=%.9f offset=%.6f time=%.4f"
            % (epoch, meters["total"].avg, meters["coarse_cd"].avg,
               meters["coarse_hd"].avg, meters["fine_cd"].avg,
               meters["fine_hd"].avg, meters["offset_mean"].avg, minutes)
        )
