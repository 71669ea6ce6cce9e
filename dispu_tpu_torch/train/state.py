"""Training state: the generator (parameters and batch-norm statistics), the
Adam moments and the epoch and step counters (counterpart of
``train/state.py``).

Where the JAX package returns a new state each step, the port updates this
one in place: parameters, moments and counters.  The learning rate and
the fine-loss weight are functions of ``epoch``, so the epoch is part of
the state and of its checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from dispu_tpu_torch.config import GeneratorConfig, TrainConfig
from dispu_tpu_torch.models.generator import DisPUGenerator

ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclasses.dataclass
class GeneratorState:
    model: DisPUGenerator
    mu: Dict[str, torch.Tensor]   # Adam first moments, by parameter name
    nu: Dict[str, torch.Tensor]   # Adam second moments
    count: int = 0                # Adam updates so far
    epoch: float = 0.0
    step: int = 0

    def next_epoch(self) -> "GeneratorState":
        self.epoch += 1.0
        return self

    def state_dict(self) -> dict:
        """Every tensor and counter, for a checkpoint."""
        return {"model": self.model.state_dict(), "mu": dict(self.mu),
                "nu": dict(self.nu), "count": self.count,
                "epoch": self.epoch, "step": self.step}

    def load_state_dict(self, saved: dict) -> "GeneratorState":
        """Copy a :meth:`state_dict` into this state's tensors."""
        self.model.load_state_dict(saved["model"])
        with torch.no_grad():
            for mine, theirs in ((self.mu, saved["mu"]),
                                 (self.nu, saved["nu"])):
                if set(mine) != set(theirs):
                    raise ValueError("saved Adam moments do not match the "
                                     "model's parameters")
                for name, value in theirs.items():
                    mine[name].copy_(value)
        self.count = int(saved["count"])
        self.epoch = float(saved["epoch"])
        self.step = int(saved["step"])
        return self


def create_generator_state(gen_cfg: GeneratorConfig, seed: int = 0,
                           impl: str = "auto",
                           device="cuda") -> GeneratorState:
    """The port's seeded init of the generator on ``device``, zero moments,
    epoch and step 0."""
    model = DisPUGenerator(gen_cfg, impl=impl, seed=seed).to(device)
    zeros = {name: torch.zeros_like(p) for name, p in
             model.named_parameters()}
    return GeneratorState(model=model, mu=zeros,
                          nu={k: torch.zeros_like(v) for k, v in zeros.items()})


def _bias_correction(decay: float, count: int) -> float:
    """``1 − decay^count`` in f32 (PyTorch's f32 pow; XLA's differs from
    it in the last bit at a few counts, none of the first thirty)."""
    f32 = torch.float32
    power = torch.tensor(decay, dtype=f32) ** torch.tensor(count, dtype=f32)
    return float(torch.tensor(1.0, dtype=f32) - power)


@torch.no_grad()
def adam_step(named_params, mu: Dict[str, torch.Tensor],
              nu: Dict[str, torch.Tensor], count: int, lr: float, b1: float,
              clip: float = 0.0) -> None:
    """One Adam step (the ``count``-th) on ``named_params`` from their
    ``.grad`` (none counts as zero), moments and parameters in place.

    ``optax.scale_by_adam`` term for term, then ``p ← p − lr·u``:
    ``mu = (1−b1)·g + b1·mu``, ``nu = (1−b2)·g² + b2·nu``,
    ``u = (mu / (1−b1^count)) / (sqrt(nu / (1−b2^count)) + eps)`` with
    b2 = 0.999 and eps = 1e-8 outside the square root.  Not
    ``torch.optim.Adam``, which folds the corrections into the step size
    and the denominator and so rounds otherwise.  The square root is taken
    in f64 and rounded to f32, which is correctly rounded (the double
    rounding is innocuous for a square root): PyTorch's vectorized CPU f32
    square root is not, and XLA's is.  ``clip`` > 0 then clips each
    parameter to [−clip, clip] (the critic's update); the moments are
    never clipped.
    """
    bc1 = _bias_correction(b1, count)
    bc2 = _bias_correction(ADAM_B2, count)
    for name, p in named_params:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        m = (1 - b1) * g + b1 * mu[name]
        v = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[name]
        root = torch.sqrt((v / bc2).double()).float()
        p.sub_(lr * ((m / bc1) / (root + ADAM_EPS)))
        if clip > 0:
            p.clamp_(-clip, clip)
        mu[name].copy_(m)
        nu[name].copy_(v)


def adam_update(state: GeneratorState, lr: float, train_cfg: TrainConfig
                ) -> None:
    """One Adam step (:func:`adam_step`) on every generator parameter,
    the count advanced first."""
    state.count += 1
    adam_step(state.model.named_parameters(), state.mu, state.nu,
              state.count, lr, train_cfg.beta1)
