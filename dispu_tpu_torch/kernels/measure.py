"""Shapes and a timer that ``chip_smoke.py`` and ``time_fps`` share.

``GATHER_CASES`` are the gather pair's shapes in a train step at batch 28
with ``gather_impl='pallas'``; :func:`device_ms` is the device time of the
kernels a call launches, from a ``torch.profiler`` trace.  Importing this
module needs only ``torch``; ``time_fps`` also loads it by path into a
checkout of another commit.
"""

from __future__ import annotations

import torch

#: (label, n, c, rows gathered per point, launches a step): the backbone's
#: first block (c 24) and its three later ones (c 48), the refiner's
#: combined [xyz | feature] gather (c 131)
GATHER_CASES = [("backbone c24", 256, 24, 16, 1),
                ("backbone c48", 256, 48, 16, 3),
                ("refiner c131", 1024, 131, 16, 1)]


def gather_inputs(gen: torch.Generator, n: int, c: int, per_point: int,
                  b: int = 28) -> tuple[torch.Tensor, torch.Tensor]:
    """A (b, n, c) table and (b, n * per_point) int32 indices into it, on
    the CPU, every ``per_point``-th index a point's own row."""
    table = torch.randn(b, n, c, generator=gen)
    idx = torch.randint(0, n, (b, n * per_point), generator=gen,
                        dtype=torch.int32)
    idx[:, ::per_point] = torch.arange(n, dtype=torch.int32)  # self rows
    return table, idx


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds a call of the kernels ``fn`` launches, from
    a torch.profiler trace of ``reps`` calls after one warm-up: the
    kernels' own time, without the host's work between launches that CUDA
    events around back-to-back calls also time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # now and then a trace holds no device events at all (seen once in 72
    # traces on an H100): trace again, at most three times in all
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(evt.time_range.elapsed_us() for evt in prof.events()
                 if evt.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError("profiler: no device time traced in three traces")
