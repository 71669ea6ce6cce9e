"""Shapes and a timer that ``chip_smoke.py`` and ``time_fps`` share.

``KNN_CASES`` and ``KNN_GROUP_CASES`` are the kNN kernels' shapes on the
serving and training paths, with :func:`knn_inputs` and
:func:`knn_group_inputs` to make their inputs from a seed;
``GATHER_CASES`` are the gather pair's shapes in a train step at batch 28
with ``gather_impl='pallas'``; :func:`device_ms` is the device time of the
kernels a call launches, from a ``torch.profiler`` trace.  Importing this
module needs only ``torch``; ``time_fps`` also loads it by path into a
checkout of another commit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KnnCase(NamedTuple):
    """One exact kNN launch: ``b`` clouds of ``n`` points in ``c``
    dimensions, ``m`` queries each, ``k`` neighbours; ``dup``: the last 8
    rows repeat the first 8 and duplicates carry the 1e30 column bias
    (``knn_unique``); ``queries``: ``"self"`` (the points), ``"patch"`` (24
    points of the cloud, every 85th) or ``"other"`` (a cloud of their
    own); ``per_request``: launches in a 2048-point 4× request;
    ``per_step``: launches in a CD train step at batch 28."""
    label: str
    b: int
    n: int
    m: int
    c: int
    k: int
    dup: bool
    queries: str
    per_request: int
    per_step: int = 0


#: the 4× request's kNN (the patch cut over the demo cloud, the backbone's
#: four edge convolutions at c 24 and 48, the refiner's grouping), pass 2
#: of a 16× request, a train step at batch 28 (the same layers, and the
#: chamfer losses' argmins at k = 1)
KNN_CASES = [
    KnnCase("patch k256", 1, 2048, 24, 3, 256, False, "patch", 1),
    KnnCase("backbone c24", 32, 256, 256, 24, 17, True, "self", 1),
    KnnCase("backbone c48", 32, 256, 256, 48, 17, True, "self", 3),
    KnnCase("refiner", 32, 1024, 1024, 3, 16, False, "self", 1),
    KnnCase("p2 bbone c24", 32, 1024, 1024, 24, 17, True, "self", 0),
    KnnCase("p2 bbone c48", 32, 1024, 1024, 48, 17, True, "self", 0),
    KnnCase("p2 refiner", 32, 4096, 4096, 3, 16, False, "self", 0),
    KnnCase("train bb c24", 28, 256, 256, 24, 17, True, "self", 0, 1),
    KnnCase("train bb c48", 28, 256, 256, 48, 17, True, "self", 0, 3),
    KnnCase("train refiner", 28, 1024, 1024, 3, 16, False, "self", 0, 1),
    KnnCase("chamfer k1", 28, 1024, 1024, 3, 1, False, "other", 0, 8),
]


class KnnGroupCase(NamedTuple):
    """One fused kNN + gather launch over ``b`` clouds of ``n`` points in
    ``c`` dimensions, each point its own query: ``cf`` feature columns
    (0: the points are the features), ``k`` neighbours, ``exact`` or the
    turbo bf16 rounding, ``with_xyz``, ``drop_first`` (with the last 8
    rows repeating the first 8 and the duplicate bias); ``per_request``:
    launches in a 2048-point 4× turbo request; ``per_step``: in a train
    step at batch 28 with ``fused_grouping``."""
    label: str
    b: int
    n: int
    c: int
    cf: int
    k: int
    exact: bool
    with_xyz: bool
    drop_first: bool
    per_request: int
    per_step: int = 0


#: the turbo 4× request's (the refiner's grouping, the backbone's edge
#: gathers), exact mode at the refiner's shape, pass 2 of a 16× request,
#: a train step with ``fused_grouping`` (exact gathers)
KNN_GROUP_CASES = [
    KnnGroupCase("refiner", 32, 1024, 3, 128, 16, False, True, False, 1),
    KnnGroupCase("refiner exact", 32, 1024, 3, 128, 16, True, True, False,
                 0),
    KnnGroupCase("bbone c24", 32, 256, 24, 0, 16, False, False, True, 1),
    KnnGroupCase("bbone c48", 32, 256, 48, 0, 16, False, False, True, 3),
    KnnGroupCase("p2 bbone c24", 32, 1024, 24, 0, 16, False, False, True,
                 0),
    KnnGroupCase("p2 bbone c48", 32, 1024, 48, 0, 16, False, False, True,
                 0),
    KnnGroupCase("train bb c24", 28, 256, 24, 0, 16, True, False, True, 0,
                 1),
    KnnGroupCase("train bb c48", 28, 256, 48, 0, 16, True, False, True, 0,
                 3),
    KnnGroupCase("train refiner", 28, 1024, 3, 128, 16, True, True, False,
                 0, 1),
]


def _cloud(gen: torch.Generator, b: int, n: int, c: int,
           n_dup: int) -> torch.Tensor:
    x = torch.randn(b, n, c, generator=gen)
    x[:, n - n_dup:] = x[:, :n_dup]  # duplicated rows, as in patches
    return x


def knn_inputs(gen: torch.Generator, cases=KNN_CASES,
               patch_cloud: torch.Tensor | None = None) -> list:
    """(points, queries or None for the points, dup) a case, on the CPU,
    drawn in the order of ``cases``; a ``"patch"`` case takes its points
    from ``patch_cloud`` ((n, 3), e.g. a normalized demo cloud)."""
    out = []
    for case in cases:
        if case.queries == "patch":
            pts = patch_cloud[None]
            qs = pts[:, ::85][:, :case.m]
        else:
            pts = _cloud(gen, case.b, case.n, case.c, 8 if case.dup else 0)
            qs = (_cloud(gen, case.b, case.m, case.c, 0)
                  if case.queries == "other" else None)
        out.append((pts.contiguous(),
                     None if qs is None else qs.contiguous()))
    return out


def knn_group_inputs(gen: torch.Generator, cases=KNN_GROUP_CASES) -> list:
    """(points, features or None for the points) a case, on the CPU, drawn
    in the order of ``cases``; cases of one (b, n, c, cf, drop_first)
    share their inputs."""
    drawn, out = {}, []
    for case in cases:
        key = (case.b, case.n, case.c, case.cf, case.drop_first)
        if key not in drawn:
            pts = _cloud(gen, case.b, case.n, case.c,
                         8 if case.drop_first else 0)
            ft = (_cloud(gen, case.b, case.n, case.cf, 0) if case.cf
                  else None)
            drawn[key] = (pts, ft)
        out.append(drawn[key])
    return out

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
