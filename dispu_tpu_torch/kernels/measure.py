"""Shapes and a timer that ``chip_smoke.py`` and ``time_fps`` share.

``KNN_CASES`` and ``KNN_GROUP_CASES`` are the kNN kernels' shapes on the
serving and training paths (``KNN_WIDE_CASES`` the exact kNN's past k = 32
beside the 4× patch cut), with :func:`knn_inputs` and
:func:`knn_group_inputs` to make their inputs from a seed;
``GATHER_CASES`` are the gather pair's shapes in a train step at batch 28
with ``gather_impl='pallas'``; ``SCATTER_CASES`` the scatter kernel's in a
train step with ``gather_impl='pallas'`` and with ``fused_grouping``;
``BUCKETED_CASES`` the bucketed merge FPS's on the turbo serving path;
``BALL_CASES`` the ball query's in a CD and
a GAN step, with :func:`ball_inputs`; ``REFINE_CASES`` are the fused
refiner kernels' two passes (and pass 2 at ``patch_num_point`` 512),
with :func:`refine_params`, :func:`refine_ops` and :func:`refine_chain`;
:func:`device_ms` is the
device time of the
kernels a call launches, from a ``torch.profiler`` trace, and
:func:`device_ms_by_kernel` the same by kernel name.  Importing this
module needs only ``torch``; ``time_fps`` also loads it by path into a
checkout of another commit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class KnnCase(NamedTuple):
    """One exact kNN launch: ``b`` clouds of ``n`` points in ``c``
    dimensions, ``m`` queries each, ``k`` neighbours; ``dup``: the last 8
    rows repeat the first 8 and duplicates carry the 1e30 column bias
    (``knn_unique``); ``queries``: ``"self"`` (the points), ``"patch"`` (m
    points of the demo cloud, every 85th), ``"scan"`` (the same of a
    scan of n points) or ``"other"`` (a cloud of their own); ``per_request``: launches in a 2048-point 4× request;
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
#: chamfer losses' argmins at k = 1), and the evaluation's ``cd_hd``
#: argmin at k = 1 of a 4× and a 16× output (8,192 and 32,768 queries)
#: against a 2048-point gt cloud
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
    KnnCase("eval 4x k1", 1, 2048, 8192, 3, 1, False, "other", 0),
    KnnCase("eval 16x k1", 1, 2048, 32768, 3, 1, False, "other", 0),
]


#: exact kNN shapes past k = 32 that a 2048-point 4× request does not
#: make (its patch cut is ``KNN_CASES``' first): the patch cut of a
#: 60,000-point scan (703 queries; the radix form's 'split' regime), the
#: GCN backbone's k 48 graph (28 × 256, c 24; ``nn/gcn.py``), and the
#: patch cut at 'megafused''s ``patch_num_point`` 512 (12 queries of the
#: 2048-point cloud); ``per_request`` 0, so that a 4× request's aggregate
#: stays ``KNN_CASES``'
KNN_WIDE_CASES = [
    KnnCase("scan60k k256", 1, 60000, 703, 3, 256, False, "scan", 0),
    KnnCase("gcn k48", 28, 256, 256, 24, 48, False, "self", 0),
    KnnCase("patch k512", 1, 2048, 12, 3, 512, False, "patch", 0),
]


def scan_cloud(n: int, seed: int) -> torch.Tensor:
    """(n, 3) f32 points on a torus's surface (radii 1 and 0.35) with
    noise, from a numpy seed (``chip_smoke.py``'s ``big_cloud``), centred
    and scaled by its furthest point as a request normalizes it."""
    import numpy as np

    rs = np.random.RandomState(seed)
    u, v = rs.uniform(0.0, 2.0 * np.pi, (2, n))
    ring = 1.0 + 0.35 * np.cos(v)
    pts = np.stack([ring * np.cos(u), ring * np.sin(u), 0.35 * np.sin(v)], 1)
    x = torch.from_numpy((pts + 0.002 * rs.randn(n, 3)).astype(np.float32))
    x = x - torch.mean(x, dim=0, keepdim=True)
    return x / torch.amax(torch.sqrt(torch.sum(x * x, dim=-1)))


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
    from ``patch_cloud`` ((n, 3), e.g. a normalized demo cloud), a
    ``"scan"`` case from :func:`scan_cloud` (seed 11), both every 85th
    point as the queries."""
    out = []
    for case in cases:
        if case.queries in ("patch", "scan"):
            pts = (patch_cloud if case.queries == "patch"
                   else scan_cloud(case.n, 11))[None]
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


class ScatterCase(NamedTuple):
    """One scatter-add launch of a CD train step at batch 28: ``b`` clouds
    of ``q`` rows of ``c`` floats summed into ``n`` rows; ``setting``: the
    step's ``GeneratorConfig`` flag that sends it to the kernel
    (``"pallas"``: ``gather_impl='pallas'``, the gather's backward;
    ``"fused_grouping"``: ``KnnGroupFunction``'s backward), ``per_step``:
    launches in one such step."""
    label: str
    setting: str
    b: int
    q: int
    c: int
    n: int
    per_step: int


#: the gathers' backward with ``gather_impl='pallas'`` (``GATHER_CASES``'
#: cotangents), and with ``fused_grouping`` the backbone's feature rows
#: (k 16) and the refiner's feature and xyz rows (128 features, k 16)
SCATTER_CASES = [
    *(ScatterCase(f"pallas {label}", "pallas", 28, n * per_point, c, n,
                  launches)
      for label, n, c, per_point, launches in GATHER_CASES),
    ScatterCase("fused backbone c24", "fused_grouping", 28, 4096, 24, 256, 1),
    ScatterCase("fused backbone c48", "fused_grouping", 28, 4096, 48, 256, 3),
    ScatterCase("fused refiner c128", "fused_grouping", 28, 16384, 128, 1024,
                1),
    ScatterCase("fused refiner xyz", "fused_grouping", 28, 16384, 3, 1024, 1),
]


def scatter_inputs(gen: torch.Generator, case: ScatterCase
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(g (b, q, c), int32 indices (b, q)) of the case on the CPU: the
    indices of :func:`gather_inputs` (every ``q // n``-th a row's own), the
    cotangents N(0, 1)."""
    _, idx = gather_inputs(gen, case.n, 1, case.q // case.n, case.b)
    return torch.randn(case.b, case.q, case.c, generator=gen), idx


class BucketedCase(NamedTuple):
    """One launch of the bucketed merge FPS: ``k`` buckets of ``nb``
    points → ``mb`` local picks each; ``per_request``: launches in one
    turbo request (or streaming call) of its kind."""
    label: str
    k: int
    nb: int
    mb: int
    per_request: int


#: the turbo merge of a 2048-point cloud at 4× (24,576 candidates → 64
#: buckets) and at 16× (98,304), ``upsample_many`` of two such clouds
#: (one launch, 128 buckets), and a 60,000-point cloud at 4× (719,872
#: candidates → 240,000 points)
BUCKETED_CASES = [
    BucketedCase("4x merge", 64, 384, 128, 1),
    BucketedCase("16x merge", 64, 1536, 512, 1),
    BucketedCase("4x stream B=2", 128, 384, 128, 1),
    BucketedCase("16x stream B=2", 128, 1536, 512, 1),
    BucketedCase("60,000-point 4x", 64, 11248, 3750, 1),
]


def bucketed_inputs(gen: torch.Generator, case: BucketedCase) -> torch.Tensor:
    """(k, nb, 3) buckets of the case on the CPU, N(0, 1), the last 10
    points of each bucket repeating its first 10 (tied distances)."""
    x = torch.randn(case.k, case.nb, 3, generator=gen)
    x[:, case.nb - 10:] = x[:, :10]
    return x


class BallCase(NamedTuple):
    """One ball-query launch: ``b`` clouds of ``n`` points in ``c``
    dimensions, ``m`` queries each (every ``n // m``-th point), ``radius``,
    ``nsample`` slots, ``select`` of them chosen in the kernel;
    ``per_cd_step`` / ``per_gan_step``: launches in a CD / GAN train step
    at batch 28 (``cli.build_config`` of ``--phase train --use_gan
    true``)."""
    label: str
    b: int
    n: int
    m: int
    c: int
    radius: float
    nsample: int
    select: int
    per_cd_step: int
    per_gan_step: int


#: the repulsion loss (every point a query), the critic's ball grouping
#: at its widest scale (``DiscriminatorConfig(knn=False)``: 128 seeds,
#: nsample 64; no default path), and the ``uniform`` metric's five disks
#: (51 seeds, nsample max(int(1024 p), 2), radius sqrt(p))
BALL_CASES = [
    BallCase("repulsion", 28, 1024, 1024, 3, 0.07, 20, 5, 1, 1),
    BallCase("critic ball", 28, 1024, 128, 3, 0.4, 64, 5, 0, 0),
    *(BallCase(f"uniform {p:.3f}", 28, 1024, 51, 3, math.sqrt(p),
               max(int(1024 * p), 2), 0, 0, 1)
      for p in (0.004, 0.006, 0.008, 0.010, 0.012)),
]


def ball_inputs(gen: torch.Generator, case: BallCase):
    """(points, queries) of the case on the CPU: points on a sphere's
    surface with noise (a patch's density at r 0.07), the last 50 points
    repeating 50 earlier ones (tied distances), the queries every
    ``n // m``-th point."""
    x = torch.randn(case.b, case.n, case.c, generator=gen)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    x = x + 0.01 * torch.randn(x.shape, generator=gen)
    x[:, -50:] = x[:, 100:150]
    return x.contiguous(), x[:, ::case.n // case.m][:, :case.m].contiguous()


class RefineCase(NamedTuple):
    """One launch of a fused refiner kernel (``refine_local`` on grouped
    rows, ``refine_block`` on points and features) at ``GeneratorConfig()``
    width: ``b`` patches of ``n`` points, ``k`` neighbours, ``c`` features
    (grouped rows of 6 + c floats), the refiner's ``mlp`` (c1, c2, c_out);
    ``per_request``: launches in a 2048-point 4× request with
    ``refine_local_impl`` 'fused' (of ``refine_block`` with 'megafused'),
    ``per_16x``: in a 16× one, both at the default ``patch_num_point``;
    ``patch``: the ``patch_num_point`` whose requests make the launch."""
    label: str
    b: int
    n: int
    k: int
    c: int
    mlp: tuple
    per_request: int
    per_16x: int
    patch: int = 256


#: the refiner of a generator pass over a chunk of 32 patches of 256
#: points (pass 1: a 4× request's, and a 16× request's first), of 1024
#: points (pass 2, a 16× request's second), and of 2048 points (pass 2 of
#: a 16× request at ``patch_num_point`` 512, 8,192 points a patch)
REFINE_CASES = [
    RefineCase("pass 1", 32, 1024, 16, 128, (128, 128, 256), 1, 1),
    RefineCase("pass 2", 32, 4096, 16, 128, (128, 128, 256), 0, 1),
    RefineCase("pass 2, patch 512", 32, 8192, 16, 128, (128, 128, 256), 0,
               0, 512),
]


def refine_params(gen: torch.Generator, case: RefineCase) -> list:
    """Random parameters of the case's width on the CPU, in
    ``LocalParams`` order (w0, b0, w1, b1, ww, bw, wsk, bsk, waf, baf):
    each kernel scaled by 1/sqrt(fan-in), so that every layer's output
    stays O(1), each bias 0.1 x N(0, 1)."""
    c1, c2, co = case.mlp
    cf, k = 6 + case.c, case.k

    def w(*shape):
        fan_in = shape[-2] * (shape[0] if len(shape) == 3 else 1)
        return torch.randn(*shape, generator=gen) / fan_in ** 0.5

    def bias(n):
        return 0.1 * torch.randn(n, generator=gen)

    return [w(cf, c1), bias(c1), w(c1, c2), bias(c2), w(3, k), bias(k),
            w(cf, co), bias(co), w(k, c2, co), bias(co)]


def refine_ops(case: RefineCase) -> int:
    """f32 operations of the local and skip branches over the case's
    b·n queries (a multiply-add counts two)."""
    c1, c2, co = case.mlp
    cf, k = 6 + case.c, case.k
    per_row = 2 * (cf * c1 + c1 * c2 + 3 * k) + 2 * k * c2
    return case.b * case.n * (k * per_row + 2 * k * c2 * co + 2 * cf * co)


def refine_chain(p):
    """The composed branch as one would write it with PyTorch's own calls
    on ``LocalParams`` p (no single call computes it): ``F.linear`` for
    conv0, conv1, the weight net, after_conv and skip (cuBLAS; TF32 as the
    caller set it), a batched matmul for the pooling, ``amax`` for the
    skip's max.  Returns grouped (b, n, k, cf) → (b, n, c_out)."""
    import torch.nn.functional as F

    wt = [t.t().contiguous() for t in (p.w0, p.w1, p.ww, p.wsk)]
    waf = p.waf.reshape(-1, p.waf.shape[-1]).t().contiguous()

    def run(g):
        b, n = g.shape[:2]
        h = F.relu(F.linear(F.relu(F.linear(g, wt[0], p.b0)), wt[1], p.b1))
        w = F.relu(F.linear(g[..., :3], wt[2], p.bw))
        pool = torch.matmul(w.transpose(-1, -2), h).reshape(b, n, -1)
        return (F.relu(F.linear(pool, waf, p.baf))
                + F.relu(F.linear(torch.amax(g, dim=2), wt[3], p.bsk)))

    return run


def _device_events(fn, reps: int) -> list:
    """The device events of a torch.profiler trace of ``reps`` calls of
    ``fn`` after one warm-up."""
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
        events = [evt for evt in prof.events()
                  if evt.device_type == DeviceType.CUDA]
        if sum(evt.time_range.elapsed_us() for evt in events) > 0:
            return events
    raise RuntimeError("profiler: no device time traced in three traces")


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds a call of the kernels ``fn`` launches, from
    a torch.profiler trace of ``reps`` calls after one warm-up: the
    kernels' own time, without the host's work between launches that CUDA
    events around back-to-back calls also time."""
    return sum(evt.time_range.elapsed_us()
               for evt in _device_events(fn, reps)) / 1e3 / reps


def kernel_name(name: str) -> str:
    """A device event's kernel name without its namespace, return type
    and arguments: ``"void (anonymous namespace)::sum_kernel<float, 4>(float
    const*, ...)"`` → ``"sum_kernel<float, 4>"``."""
    import re

    if name.startswith(("Memcpy", "Memset")):
        return name
    m = re.search(r"(\w+)\s*(<[^()]*>)?\s*\(",
                  name.replace("(anonymous namespace)::", "").replace(
                      "void ", ""))
    return (m.group(1) + (m.group(2) or "")) if m else name


def device_ms_by_kernel(fn, reps: int) -> dict[str, float]:
    """:func:`device_ms` split by kernel (:func:`kernel_name`): mean device
    milliseconds a call of ``fn`` spends in each kernel it launches."""
    out: dict[str, float] = {}
    for evt in _device_events(fn, reps):
        key = kernel_name(evt.name)
        out[key] = out.get(key, 0.0) + evt.time_range.elapsed_us() / 1e3 / reps
    return out
