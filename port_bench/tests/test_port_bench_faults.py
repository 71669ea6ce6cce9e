"""A run's check on the CPU at a size a test holds, through the program's
plain versions: sound, it comes out correct; with the timed path broken
underneath (each fault a cell can have), ``correct`` comes out false.
The run's look for a card is skipped: ``lib.bench.run`` is called with
the CPU device.  And ``run.py`` itself refuses to run without a card."""

import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from port_bench.lib import cell as C
from port_bench.lib.bench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
SERVE = {"points": 512, "pool": 2, "check_clouds": 1, "warm_requests": 1,
         "profile_units": 1}
TRAIN = {"batch": 4, "patches": 40, "profile_units": 1}


def _run(monkeypatch, workload, fault=None, seconds=0.5):
    """``run`` on the CPU with the cell's sizes cut to what a test holds
    and, with ``fault``, the program broken underneath (``fault`` patches
    the program's code before the run builds it)."""
    small = SERVE if workload.startswith("up") else TRAIN
    if workload == "up16x-2k":
        small = dict(small, points=256)
    traffic = C.traffic
    monkeypatch.setattr(C, "traffic",
                        lambda name: dict(traffic(name), **small))
    if fault is not None:
        fault(monkeypatch)
    with open(os.devnull, "w") as log:
        return run(workload, 987654321987, seconds, 0, torch.device("cpu"),
                   time.time(), log=log)


@pytest.mark.parametrize("workload", ["up4x-2k", "train-cd", "train-gan"])
def test_sound_run_is_correct(monkeypatch, workload):
    r = _run(monkeypatch, workload)
    assert r["correct"], r["checks"]
    assert list(r["checks"]) == list(C.Cell(workload).limits)


def _alter_answer(mp):
    """The merged cloud's first point moved where the merge produces it."""
    from dispu_tpu_torch.inference import PatchUpsampler

    merge = PatchUpsampler.merge

    def broken(self, points, out_num):
        out = merge(self, points, out_num).clone()
        out[:, 0] += 1e-3
        return out
    mp.setattr(PatchUpsampler, "merge", broken)


def _break_steps(mp, wrap):
    """Every train step the program makes, CD and GAN, as ``wrap(step)``."""
    import dispu_tpu_torch.train.gan_steps as gan_steps
    import dispu_tpu_torch.train.steps as steps

    for mod, name in ((steps, "make_train_step"),
                      (gan_steps, "make_gan_train_step")):
        make = getattr(mod, name)
        mp.setattr(mod, name,
                   lambda *a, _make=make, **k: wrap(_make(*a, **k)))


def _state_unchanged(mp):
    """Each step computes its metrics and leaves every parameter and
    moment as it found it."""
    def wrap(step):
        def broken(state, gt, radius, gen):
            nets = [m for m in (getattr(state, "model", None),
                                getattr(state, "disc", None))
                    if m is not None]
            before = [[p.detach().clone() for p in n.parameters()]
                      for n in nets]
            out = step(state, gt, radius, gen)
            with torch.no_grad():
                for n, ps in zip(nets, before):
                    for p, b in zip(n.parameters(), ps):
                        p.copy_(b)
            return out
        return broken
    _break_steps(mp, wrap)


def _half_batch(mp):
    """Half of each batch left out, the mean taken over the rest."""
    def wrap(step):
        def broken(state, gt, radius, gen):
            h = gt.shape[0] // 2
            return step(state, gt[:h], radius[:h], gen)
        return broken
    _break_steps(mp, wrap)


@pytest.mark.parametrize("workload,fault", [
    ("up4x-2k", _alter_answer), ("up16x-2k", _alter_answer),
    ("train-cd", _state_unchanged), ("train-gan", _state_unchanged),
    ("train-cd", _half_batch), ("train-gan", _half_batch)])
def test_fault_is_caught(monkeypatch, workload, fault):
    r = _run(monkeypatch, workload, fault)
    assert not r["correct"], r["checks"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "up4x-2k",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
