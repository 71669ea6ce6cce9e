"""The precision control, and a training cell's planted fault of half a
batch, on the card at each cell's own size: each must come out not
correct by the cell's limits, on three seeds.  And the serving program's
own numbers on a dozen seeds, each after a short window at the cell's
load, which must come out correct: the lower readings of those limits.
``python -m pytest port_bench/tests/test_port_bench_control.py -s`` on a
machine with a card (about five minutes); it skips without one.  The
readings print, for the limits' record in PERF.md."""

import pytest
import torch

from port_bench.lib.cell import Cell, driver
from port_bench.lib.check import judge

SEEDS = (2_147_483_659, 3_000_000_019, 4_000_000_007)
SOUND_SEEDS = tuple(5_000_000_000 + 1_000_003 * i for i in range(12))
#: long enough to send every cloud of the pool, so each checked one
SOUND_SECONDS = {"up4x-2k": 2.0, "up16x-2k": 5.0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _fails(workload, numbers):
    ok, rows = judge(numbers, Cell(workload).limits)
    print(workload, {k: v for k, v in numbers.items()})
    return not ok


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["up4x-2k", "up16x-2k"])
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails(card, workload, seed):
    from port_bench.tests.controls import serve_control

    assert _fails(workload, serve_control(workload, seed, card))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["train-gan", "train-cd"])
@pytest.mark.parametrize("fault", ["tf32", "half_batch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_fails(card, workload, fault, seed):
    from port_bench.tests.controls import train_control

    assert _fails(workload, train_control(workload, seed, card, fault))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["up4x-2k", "up16x-2k"])
def test_serving_program_is_sound_on_a_dozen_seeds(card, workload):
    cell = Cell(workload)
    Driver = driver(cell.traffic["driver"])
    bad = []
    for seed in SOUND_SEEDS:
        drv = Driver(cell, seed, card)
        drv.window(SOUND_SECONDS[workload], traced=False)
        drv.free_program()
        numbers = drv.check(True)
        print(workload, seed, numbers)
        ok, rows = judge(numbers, cell.limits)
        if not ok:
            bad.append((seed, rows))
        del drv
        torch.cuda.empty_cache()
    assert not bad, bad
