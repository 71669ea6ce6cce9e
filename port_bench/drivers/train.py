"""The trainer's loop shape over a device-resident patch set: each step's
batch picked by host indices from an epoch order shuffled by a numpy
``RandomState`` (copied to the card, rows gathered there), the program's
step called, its metrics summed on the card and fetched to the host every
``fetch_every`` steps, as ``train.trainer.Trainer`` does; no host fetch
otherwise, so the host enqueues ahead of the card.

Set-up builds one state from the seed's weights and drives it through
the first ``warm_steps`` steps of that loop (which warm every shape);
what the check needs of them is kept: each step's losses, the first
gradient (from Adam's first moment after one step) and the parameters
after the last.  The window continues the same state.
"""

from __future__ import annotations

import time

import torch

from port_bench.lib import data
from port_bench.lib.cell import dataclass_args
from port_bench.lib.timing import Clock, slice_rates

LOSS_KEYS = ("total", "d_loss", "uniform")


class Driver:
    """Set-up, window, traced sub-window and check of one training cell.

    Set-up is :meth:`inputs` (the weights and the patch set, all the
    reference needs), :meth:`build` (the program's state and step) and
    :meth:`warm` (the first steps, whose results the check keeps)."""

    def __init__(self, cell, seed, device, log=None):
        clock = Clock(log)
        self.inputs(cell, seed, device)
        clock("weights and patches")
        self.build()
        clock("program")
        self.warm(clock)

    def inputs(self, cell, seed, device):
        from dispu_tpu_torch.config import (DataConfig, DiscriminatorConfig,
                                            ExperimentConfig,
                                            GeneratorConfig, LossConfig,
                                            TrainConfig)

        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.gan = bool(cfg["use_gan"])
        args = dataclass_args
        ecfg = ExperimentConfig(
            generator=GeneratorConfig(**args(cfg["generator"])),
            discriminator=DiscriminatorConfig(
                **args(cfg.get("discriminator", {}))),
            loss=LossConfig(**args(cfg["loss"])),
            train=TrainConfig(**dict(args(cfg["train"]),
                                     batch_size=tr["batch"])),
            data=DataConfig(**args(cfg["data"])), use_gan=self.gan)
        self.ecfg = ecfg
        self.batch = tr["batch"]
        self.fetch_every = tr["fetch_every"]
        self.n_in = ecfg.generator.num_points
        self.weights = {"G": data.weights(cfg["weights"]["generator"], seed,
                                          device)}
        if self.gan:
            self.weights["D"] = data.weights(cfg["weights"]["critic"], seed,
                                             device, stream=5)
        self.patches = data.make(tr["shape"], tr["patches"],
                                 tr["patch_points"], tr["shape_params"],
                                 seed, device)
        self.radius = torch.ones(tr["patches"], device=device)
        self.rng = data.host_rng(seed, 3)
        self.order, self.at = None, 0
        self.steps = 0
        self.sums = None
        self.first_batches = []

    def build(self):
        self.state, self.step_fn = self._program(self.device)
        self.gen = data.generator(self.seed, 2, self.device)

    def warm(self, clock):
        """The loop's first ``warm_steps`` steps, enqueued as the window
        enqueues them (no synchronize between them), keeping what the
        check compares."""
        self.record = {"losses": []}
        for i in range(self.cell.traffic["warm_steps"]):
            idx = self.next_indices()
            self.first_batches.append(idx)
            metrics, _ = self.step(idx)
            clock(f"step {i + 1} enqueued")
            self.record["losses"].append(
                {k: metrics[k] for k in LOSS_KEYS if k in metrics})
            if i == 0:
                self.record["grads"] = self._first_grads()
        self.record["after"] = self._params()
        self.record["losses"] = [{k: float(v) for k, v in m.items()}
                                 for m in self.record["losses"]]
        self.record["start"] = {
            net: {k: v for k, v in w.items() if k in self.record["after"][net]}
            for net, w in self.weights.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        clock("steps done")

    def _program(self, device):
        if self.gan:
            from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                         make_gan_train_step)

            state = create_gan_state(self.ecfg, device=device)
            state.gen.model.load_state_dict(self.weights["G"])
            state.disc.load_state_dict(self.weights["D"])
            return state, make_gan_train_step(self.ecfg, device=device)
        from dispu_tpu_torch.train.state import create_generator_state
        from dispu_tpu_torch.train.steps import make_train_step

        state = create_generator_state(self.ecfg.generator, device=device)
        state.model.load_state_dict(self.weights["G"])
        return state, make_train_step(self.ecfg, device=device)

    def _nets(self):
        if self.gan:
            st = self.state
            return {"G": (st.gen.model, st.gen.mu),
                    "D": (st.disc, st.d_mu)}
        return {"G": (self.state.model, self.state.mu)}

    def _first_grads(self):
        b1 = self.ecfg.train.beta1
        return {net: {k: (v / (1 - b1)).clone() for k, v in mu.items()}
                for net, (_, mu) in self._nets().items()}

    def _params(self):
        """A copy of every parameter, by net and name."""
        return {net: {k: p.detach().clone()
                      for k, p in model.named_parameters()}
                for net, (model, _) in self._nets().items()}

    def next_indices(self):
        """The next batch's patch indices (host int64), a new shuffled
        order each epoch, as ``PatchDataset.epoch_indices``."""
        n = len(self.radius)
        per_epoch = n // self.batch
        if self.order is None or self.at >= per_epoch:
            if self.order is not None:
                self.state.next_epoch()
            self.order = self.rng.permutation(n)
            self.at = 0
        idx = self.order[self.at * self.batch:(self.at + 1) * self.batch]
        self.at += 1
        return idx

    def step(self, idx):
        """One step of the loop; returns its metrics and the host seconds
        the program's step call took to return."""
        dev_idx = torch.from_numpy(idx).to(self.device)
        gt, radius = self.patches[dev_idx], self.radius[dev_idx]
        t0 = time.perf_counter()
        self.state, metrics = self.step_fn(self.state, gt, radius, self.gen)
        enqueue = time.perf_counter() - t0
        self.steps += 1
        self.sums = metrics if self.sums is None else {
            k: self.sums[k] + metrics[k] for k in self.sums}
        if self.steps % self.fetch_every == 0:
            _ = {k: float(v) for k, v in metrics.items()}
        return metrics, enqueue

    def window(self, seconds, traced):
        """Steps until ``seconds`` have passed, then a synchronize; with
        ``traced`` each ``step()`` call's host seconds too."""
        enq, done_at, n0 = [], [], self.steps
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            _, host_s = self.step(self.next_indices())
            done_at.append(time.perf_counter() - t0)
            if traced:
                enq.append(host_s)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - t0
        steps = self.steps - n0
        return dict(attempted=steps, done=steps, failed=0,
                    window_s=window_s, enqueue_s=enq, done_at=done_at)

    def metrics(self, record):
        return {"train_patches_per_s":
                self.batch * record["done"] / record["window_s"]}

    def log_window(self, record, log):
        print("steps enqueued /s by 5 s: " + " ".join(
            f"{r:.2f}" for r in slice_rates(record["done_at"],
                                            record["window_s"])), file=log)

    def run_n(self, n):
        """``n`` steps inside harness spans (the traced sub-window)."""
        from torch.profiler import record_function

        for _ in range(n):
            with record_function("bench.batch"):
                idx = self.next_indices()
                dev_idx = torch.from_numpy(idx).to(self.device)
            with record_function("bench.step"):
                self.state, metrics = self.step_fn(
                    self.state, self.patches[dev_idx], self.radius[dev_idx],
                    self.gen)
            self.steps += 1
            if self.steps % self.fetch_every == 0:
                with record_function("bench.fetch"):
                    _ = {k: float(v) for k, v in metrics.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def flops_per_unit(self):
        from port_bench.lib.counting import step_flops

        return step_flops(self.weights, self.batch, self.gan,
                          self.patches.shape[1], self.n_in)

    def free_program(self):
        self.state = self.step_fn = None

    def check(self, bf16):
        """The reference's first steps from the same weights, batches and
        draws; the numbers against the program's record."""
        from port_bench.lib.check import train_numbers

        return train_numbers(self.record, reference_record(self, bf16))


def reference_record(cell, bf16, batch_rows=None):
    """The reference over the set-up's batches (with ``batch_rows``, on
    those rows of each alone), in the record's form."""
    from port_bench.reference.training import Trainer

    gen = data.generator(cell.seed, 2, cell.device)
    ref = Trainer(cell.weights["G"], cell.weights.get("D"),
                  attention_bf16=bf16,
                  gen_update=cell.ecfg.train.gen_update,
                  d_clip=cell.ecfg.train.d_clip,
                  lr_d=cell.ecfg.train.base_lr_d)
    losses = []
    for idx in cell.first_batches:
        dev_idx = torch.from_numpy(idx).to(cell.device)
        out = ref.step(cell.patches[dev_idx], cell.radius[dev_idx], gen,
                       n_in=cell.n_in, batch_rows=batch_rows)
        losses.append({k: float(v) for k, v in out.items()})
    nets = list(ref.state)
    return {"losses": losses, "grads": ref.first_grads,
            "after": {n: {k: v.detach() for k, v in
                          ref.params(n).items()} for n in nets},
            "start": {n: {k: v for k, v in cell.weights[n].items()
                          if k in ref.params(n)} for n in nets}}

