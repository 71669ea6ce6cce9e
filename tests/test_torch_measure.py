"""The shapes that ``chip_smoke.py`` and ``time_fps`` share
(``dispu_tpu_torch/kernels/measure.py``), on the CPU: ``GATHER_CASES``
are the gathers that a train step with ``gather_impl='pallas'`` sends to
the gather kernel at the default widths, and ``gather_inputs`` makes what
it says.
"""

import collections

import pytest
import torch

from dispu_tpu_torch import GeneratorConfig
from dispu_tpu_torch.kernels.measure import GATHER_CASES, gather_inputs
from dispu_tpu_torch.models.generator import DisPUGenerator
from dispu_tpu_torch.ops import grouping


@pytest.fixture(scope="module")
def kernel_gathers():
    """(n, c, rows gathered per point) → count of the gathers that
    ``group_point(gather_impl='pallas')`` sends to the kernel in one
    training-mode forward of the default generator, the kernel's wrapper
    replaced by a recorder around the plain gather."""
    seen = collections.Counter()
    real = grouping.gather_rows

    def record(points, idx, impl):
        _, n, c = points.shape
        seen[(n, c, idx.shape[1] // n)] += 1
        return real(points, idx, impl="torch")

    cfg = GeneratorConfig(gather_impl="pallas")
    torch.manual_seed(0)
    model = DisPUGenerator(cfg, impl="torch").train()
    x = torch.randn(1, cfg.num_points, 3)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(grouping, "use_kernel", lambda impl, t: True)
        mp.setattr(grouping, "gather_rows", record)
        model(x)
    return seen


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: c[0])
def test_gather_cases_are_the_train_steps_kernel_gathers(kernel_gathers,
                                                         case):
    _, n, c, per_point, launches = case
    assert kernel_gathers[(n, c, per_point)] == launches


def test_gather_cases_are_every_kernel_gather(kernel_gathers):
    assert sum(kernel_gathers.values()) == sum(
        case[-1] for case in GATHER_CASES)


def test_gather_inputs_are_seeded_with_self_rows():
    table, idx = gather_inputs(torch.Generator().manual_seed(3), 40, 5, 4,
                               b=2)
    again, idx2 = gather_inputs(torch.Generator().manual_seed(3), 40, 5, 4,
                                b=2)
    assert table.shape == (2, 40, 5) and table.dtype == torch.float32
    assert idx.shape == (2, 160) and idx.dtype == torch.int32
    assert torch.equal(table, again) and torch.equal(idx, idx2)
    assert torch.equal(idx[:, ::4], torch.arange(40).expand(2, -1).int())
    assert int(idx.min()) >= 0 and int(idx.max()) < 40
