"""The shapes that ``chip_smoke.py`` and ``time_fps`` share
(``dispu_tpu_torch/kernels/measure.py``), on the CPU: ``GATHER_CASES``
are the gathers that a train step with ``gather_impl='pallas'`` sends to
the gather kernel at the default widths, ``KNN_CASES`` and
``KNN_GROUP_CASES`` hold the kNN launches of a 4× request's generator
pass (exact and turbo), ``REFINE_CASES`` the fused refiner's launches of
a 4× and a 16× request's generator passes, ``BALL_CASES`` the ball
queries of a CD and a GAN train step and the critic's ball grouping,
``SCATTER_CASES`` the scatters of a train step's backward with
``gather_impl='pallas'`` and with ``fused_grouping``, ``BUCKETED_CASES``
the turbo merges, and the input makers make what they say.
"""

import collections
import dataclasses

import pytest
import torch

from dispu_tpu_torch import GeneratorConfig, InferenceConfig, cli
from dispu_tpu_torch.kernels import knn_group as knn_group_module
from dispu_tpu_torch.inference import plan_counts
from dispu_tpu_torch.kernels.measure import (BALL_CASES, BUCKETED_CASES,
                                             GATHER_CASES, KNN_CASES,
                                             KNN_GROUP_CASES, KNN_WIDE_CASES,
                                             REFINE_CASES,
                                             SCATTER_CASES, ball_inputs,
                                             bucketed_inputs, gather_inputs,
                                             kernel_name, knn_group_inputs,
                                             knn_inputs, refine_ops,
                                             refine_params, scatter_inputs)
from dispu_tpu_torch.kernels.refine_local import LocalParams, param_dims
from dispu_tpu_torch.models.generator import DisPUGenerator
from dispu_tpu_torch.nn import refine as refine_module
from dispu_tpu_torch.ops import grouping
from dispu_tpu_torch.ops import knn as knn_ops
from dispu_tpu_torch.ops import sampling


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


@pytest.fixture(scope="module")
def step_scatters():
    """setting → (b, q, c, n) → count of the scatter kernel's calls in one
    training-mode forward and backward of the default generator at batch
    28 with that setting, the kernels' wrappers replaced by their plain
    versions and the scatter's by a recorder around its plain version."""
    from dispu_tpu_torch.kernels import gather_rows as gather_module

    seen = {}
    for setting, cfg in (("pallas", GeneratorConfig(gather_impl="pallas")),
                         ("fused_grouping",
                          GeneratorConfig(fused_grouping=True))):
        calls = seen[setting] = collections.Counter()

        def record(g, idx, n, calls=calls):
            calls[(*g.shape, n)] += 1
            return gather_module.scatter_rows_torch(g, idx, n)

        torch.manual_seed(0)
        model = DisPUGenerator(cfg, impl="torch").train()
        x = torch.randn(28, cfg.num_points, 3)
        with pytest.MonkeyPatch.context() as mp:
            for module in (grouping, gather_module, knn_group_module):
                mp.setattr(module, "use_kernel", lambda impl, t: True)
            mp.setattr(gather_module, "gather_rows_cuda",
                       gather_module.gather_rows_torch)
            mp.setattr(knn_group_module, "knn_group_cuda",
                       knn_group_module.knn_group_torch)
            for module in (gather_module, knn_group_module):
                mp.setattr(module, "scatter_rows_cuda", record)
            sum(out.sum() for out in model(x)).backward()
    return seen


@pytest.mark.parametrize("setting", ["pallas", "fused_grouping"])
def test_scatter_cases_are_the_train_steps_scatters(step_scatters, setting):
    """Each scatter of a train step's backward with ``gather_impl='pallas'``
    (``fused_grouping``) is a row of ``SCATTER_CASES`` for that setting,
    launched as often as its ``per_step`` says."""
    want = {(case.b, case.q, case.c, case.n): case.per_step
            for case in SCATTER_CASES if case.setting == setting}
    assert dict(step_scatters[setting]) == want


def test_scatter_inputs_follow_their_cases():
    for case in SCATTER_CASES:
        small = case._replace(b=2)
        g, idx = scatter_inputs(torch.Generator().manual_seed(10), small)
        assert g.shape == (2, case.q, case.c) and g.dtype == torch.float32
        assert idx.shape == (2, case.q) and idx.dtype == torch.int32
        assert int(idx.min()) >= 0 and int(idx.max()) < case.n
        per = case.q // case.n
        assert torch.equal(idx[:, ::per],
                           torch.arange(case.n).expand(2, -1).int())


@pytest.mark.parametrize("case", BUCKETED_CASES, ids=lambda c: c.label)
def test_bucketed_cases_are_the_turbo_merges(case):
    """The bucketed merge's launch for a turbo request on a 2048-point
    cloud at 4× and 16×, for ``upsample_many`` of two at each, and for a
    60,000-point cloud at 4×: the candidates (patches × patch points ×
    ratio) of each cloud into the turbo configuration's buckets."""
    turbo = cli.build_config(cli.parse_args(["--phase", "test", "--turbo",
                                             "true"])).inference
    n, ratio, clouds = {"4x merge": (2048, 4, 1), "16x merge": (2048, 16, 1),
                        "4x stream B=2": (2048, 4, 2),
                        "16x stream B=2": (2048, 16, 2),
                        "60,000-point 4x": (60000, 4, 1)}[case.label]
    inf = dataclasses.replace(turbo, final_ratio=ratio)
    seeds, out_num = plan_counts(n, inf)
    seen = []

    def record(m_b, buckets, impl="auto"):
        seen.append((buckets.shape[0], buckets.shape[1], m_b))
        return torch.zeros((buckets.shape[0], m_b), dtype=torch.int32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sampling._fps_bucketed, "fps_bucketed", record)
        sampling.farthest_point_sample_bucketed(
            out_num, torch.zeros(clouds, seeds * inf.patch_num_point * ratio,
                                 3), n_buckets=inf.merge_fps_buckets)
    assert inf.merge_fps == "bucketed"
    assert seen == [(case.k, case.nb, case.mb)] and case.per_request == 1


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::build_kernel(int const*, int*, int*, int, "
     "int)", "build_kernel"),
    ("void (anonymous namespace)::sum_kernel<float4, 8, 1, 16>(float4 "
     "const*, int const*, int const*, float4*, long long, int, int, int)",
     "sum_kernel<float4, 8, 1, 16>"),
    ("void fps_round::fps_kernel<1, 128, 3, 0>(float const*, int*, float*, "
     "int, int)", "fps_kernel<1, 128, 3, 0>"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH (Device -> Pageable)"),
])
def test_kernel_name_drops_namespace_return_type_and_arguments(name, short):
    assert kernel_name(name) == short


def test_bucketed_inputs_repeat_their_first_points():
    case = BUCKETED_CASES[0]._replace(k=3)
    x = bucketed_inputs(torch.Generator().manual_seed(7), case)
    assert x.shape == (3, case.nb, 3) and x.dtype == torch.float32
    assert torch.equal(x[:, -10:], x[:, :10])


def _generator_pass(cfg, train):
    """One forward of ``cfg``'s generator at batch 2 on the plain
    versions: in eval mode a 4× request's generator pass over one chunk,
    in train mode a CD step's."""
    torch.manual_seed(0)
    model = DisPUGenerator(cfg, impl="torch").train(train)
    with torch.set_grad_enabled(train):
        model(torch.randn(2, cfg.num_points, 3))


def _record_knns(cfg, train):
    """(n, m, c, k, column bias or not) → count of the exact kNN calls of
    a generator forward, the kernels' entry replaced by a recorder around
    the plain version."""
    seen = collections.Counter()
    real = knn_ops._knn_kernel

    def record(k, points, queries, bias=None, impl="auto"):
        seen[(points.shape[1], queries.shape[1], points.shape[2], k,
              bias is not None)] += 1
        return real(k, points, queries, bias, impl=impl)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(knn_ops, "_knn_kernel", record)
        _generator_pass(cfg, train)
    return seen


def _record_knn_groups(cfg, train):
    """(n, c, cf, k, exact, with_xyz, drop_first) → count of the
    ``knn_group`` calls of a generator forward."""
    seen = collections.Counter()
    real = knn_group_module.knn_group

    def record(k, points, queries, feats, column_bias=None, exact=True,
               with_xyz=True, drop_first=False, impl="auto"):
        seen[(points.shape[1], points.shape[2], feats.shape[2], k, exact,
              with_xyz, drop_first)] += 1
        return real(k, points, queries, feats, column_bias, exact, with_xyz,
                    drop_first, impl=impl)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(knn_group_module, "knn_group", record)
        _generator_pass(cfg, train)
    return seen


@pytest.fixture(scope="module")
def kernel_knn_calls():
    """Each path's recorded calls: a 4× request's generator pass, exact
    (kNN) and turbo (``--turbo true``: ``knn_group``), and a train step's
    forward, default (kNN) and with ``fused_grouping`` (``knn_group``)."""
    turbo = cli.build_config(cli.parse_args(["--phase", "test", "--turbo",
                                             "true"])).generator
    return {("knn", "request"): _record_knns(GeneratorConfig(), False),
            ("knn_group", "request"): _record_knn_groups(turbo, False),
            ("knn", "train"): _record_knns(GeneratorConfig(), True),
            ("knn_group", "train"): _record_knn_groups(
                GeneratorConfig(fused_grouping=True), True)}


def _knn_key(case):
    return (case.n, case.m, case.c, case.k, case.dup)


def _group_key(case):
    return (case.n, case.c, case.cf or case.c, case.k, case.exact,
            case.with_xyz, case.drop_first)


@pytest.mark.parametrize("kind", ["knn", "knn_group"])
@pytest.mark.parametrize("path", ["request", "train"])
def test_every_generator_knn_is_a_case(kernel_knn_calls, kind, path):
    """Each kNN launch of a 4× request's generator pass (a train step's
    forward) is a row of the cases, launched as often as the row's
    ``per_request`` (``per_step``) says; the patch cut runs before the
    generator and the chamfer argmins after it."""
    cases, key = ((KNN_CASES, _knn_key) if kind == "knn"
                  else (KNN_GROUP_CASES, _group_key))
    times = "per_request" if path == "request" else "per_step"
    want = {key(case): getattr(case, times) for case in cases
            if getattr(case, times)
            and case.label not in ("patch k256", "chamfer k1")}
    assert dict(kernel_knn_calls[kind, path]) == want


def test_knn_inputs_follow_their_cases():
    cloud = torch.randn(2048, 3)
    cases = [case._replace(b=min(case.b, 2)) for case in KNN_CASES]
    inputs = knn_inputs(torch.Generator().manual_seed(1), cases, cloud)
    again = knn_inputs(torch.Generator().manual_seed(1), cases, cloud)
    for case, (pts, qs), (pts2, qs2) in zip(cases, inputs, again):
        assert pts.dtype == torch.float32 and torch.equal(pts, pts2)
        if case.queries == "patch":
            assert torch.equal(pts[0], cloud)
            assert torch.equal(qs[0], cloud[::85][:case.m])
        else:
            assert pts.shape == (case.b, case.n, case.c)
            assert (qs is None) == (case.queries == "self")
        if case.queries == "other":
            assert qs.shape == (case.b, case.m, case.c)
            assert torch.equal(qs, qs2)
        if case.dup:
            assert torch.equal(pts[:, -8:], pts[:, :8])


def test_knn_wide_inputs_follow_their_cases():
    """The exact kNN's shapes past k = 32 beside the 4× patch cut: the
    60,000-point scan centred and scaled to its furthest point, the patch
    cuts' queries every 85th point, the GCN graph's features drawn; none
    counted in a 4× request, and only the scan past the 'row' regime."""
    from dispu_tpu_torch.kernels.knn import MAX_STREAM_K, knn_form

    cloud = torch.randn(2048, 3)
    inputs = knn_inputs(torch.Generator().manual_seed(1), KNN_WIDE_CASES,
                        cloud)
    for case, (pts, qs) in zip(KNN_WIDE_CASES, inputs):
        assert case.k > MAX_STREAM_K and case.per_request == 0
        assert pts.shape == (case.b, case.n, case.c)
        assert knn_form(case.k, case.n, case.c) == (
            "split" if case.queries == "scan" else "row")
        if case.queries == "self":
            assert qs is None
            continue
        assert torch.equal(qs[0], pts[0, ::85][:case.m])
        assert qs.shape == (1, case.m, 3)
        if case.queries == "scan":
            radius = torch.sqrt(torch.sum(pts[0] ** 2, dim=-1))
            assert abs(float(radius.max()) - 1.0) < 1e-6
            assert float(pts[0].mean(0).abs().max()) < 1e-4


def test_knn_group_inputs_follow_their_cases():
    cases = [case._replace(b=2) for case in KNN_GROUP_CASES]
    inputs = knn_group_inputs(torch.Generator().manual_seed(5), cases)
    for case, (pts, ft) in zip(cases, inputs):
        assert pts.shape == (case.b, case.n, case.c)
        assert (ft is None) == (case.cf == 0)
        if ft is not None:
            assert ft.shape == (case.b, case.n, case.cf)
        if case.drop_first:
            assert torch.equal(pts[:, -8:], pts[:, :8])
    # the refiner's exact and turbo cases time one input
    assert inputs[0][0] is inputs[1][0] and inputs[0][1] is inputs[1][1]


def _record_refines(setting, points):
    """(n, k, cf, mlp) → count of the fused refiner kernels' calls in one
    eval-mode forward of ``GeneratorConfig(refine_local_impl=setting)``'s
    generator over one patch of ``points`` points, the kernels' entries
    replaced by recorders that return zeros."""
    seen = collections.Counter()

    def mlp(p):
        return (int(p.w0.shape[1]), int(p.w1.shape[1]), int(p.wsk.shape[1]))

    def record_local(grouped, params, impl="auto"):
        b, n, k, cf = grouped.shape
        seen[(n, k, cf, mlp(params))] += 1
        return torch.zeros(b, n, params.wsk.shape[1])

    def record_block(xyz, feats, params, impl="auto"):
        b, n, _ = xyz.shape
        seen[(n, params.ww.shape[1], 6 + feats.shape[2], mlp(params))] += 1
        return torch.zeros(b, n, params.wsk.shape[1])

    torch.manual_seed(0)
    model = DisPUGenerator(GeneratorConfig(refine_local_impl=setting),
                           impl="torch").eval()
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(refine_module, "refine_local", record_local)
        mp.setattr(refine_module, "refine_block", record_block)
        model(torch.randn(1, points, 3))
    return seen


@pytest.mark.parametrize("setting", ["fused", "megafused"])
def test_refine_cases_are_the_requests_refiner_calls(setting):
    """A 4× request's generator pass over 256-point patches calls the
    setting's kernel once, at pass 1's shape; a 16× request's second pass
    (1024 points) once more, at pass 2's; both over chunks of
    ``patch_batch`` patches."""
    cfg, inf = GeneratorConfig(), InferenceConfig()
    first = _record_refines(setting, cfg.num_points)
    second = _record_refines(setting, cfg.num_points * cfg.up_ratio)
    assert inf.patch_num_point == cfg.num_points
    assert dict(first) == {_refine_key(c): c.per_request
                           for c in REFINE_CASES if c.per_request}
    assert dict(first + second) == {_refine_key(c): c.per_16x
                                    for c in REFINE_CASES if c.per_16x}
    assert all(case.b == inf.patch_batch for case in REFINE_CASES)


def _refine_key(case):
    return (case.n, case.k, 6 + case.c, case.mlp)


@pytest.mark.parametrize("setting", ["fused", "megafused"])
def test_refine_patch_512_case_is_that_requests_second_pass(setting):
    """The case at ``patch_num_point`` 512 is the call a 16× request's
    second pass makes there (2,048-point patches, the refiner at 8,192):
    one, with either setting, over a chunk of ``patch_batch`` patches."""
    cfg = GeneratorConfig()
    (case,) = [c for c in REFINE_CASES if c.patch != cfg.num_points]
    assert case.patch == 512 and not case.per_request and not case.per_16x
    second = _record_refines(setting, case.patch * cfg.up_ratio)
    assert dict(second) == {_refine_key(case): 1}


def test_refine_params_are_seeded_at_the_cases_widths():
    case = REFINE_CASES[0]
    p = LocalParams(*refine_params(torch.Generator().manual_seed(4), case))
    again = refine_params(torch.Generator().manual_seed(4), case)
    assert all(torch.equal(a, b) for a, b in zip(p, again))
    assert param_dims(p, case.k, 6 + case.c) == case.mlp
    # 1/sqrt(fan-in) keeps each layer's weights O(1/sqrt(fan-in))
    assert abs(float(p.waf.std()) * (case.k * case.mlp[1]) ** 0.5 - 1) < 0.05
    # pass 1 is about 74 GFLOP, pass 2 four times that
    assert abs(refine_ops(case) / 1e9 - 74.0) < 0.1
    assert refine_ops(REFINE_CASES[1]) == 4 * refine_ops(case)


# ------------------------------------------------------------- ball queries

def _ball_key(radius, nsample, xyz, new_xyz, select_smallest=0):
    return (xyz.shape[1], new_xyz.shape[1], xyz.shape[2], float(radius),
            nsample, select_smallest)


@pytest.fixture(scope="module")
def step_ball_calls():
    """(n, m, c, radius, nsample, select) → count of the ball queries of
    one CD and one GAN step of ``cli.build_config`` of ``--phase train
    --use_gan true`` (batch 2 here: the batch enters no other dimension),
    the query replaced by a recorder around the plain version."""
    import dataclasses

    from dispu_tpu_torch import losses
    from dispu_tpu_torch.train.gan_steps import (create_gan_state,
                                                 make_gan_train_step)
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step

    full = cli.build_config(cli.parse_args(["--phase", "train",
                                            "--use_gan", "true"]))
    cfg = dataclasses.replace(full, train=dataclasses.replace(full.train,
                                                              batch_size=2))
    real = losses.query_ball_point
    seen = {"cd": collections.Counter(), "gan": collections.Counter()}
    gt = torch.randn(2, cfg.generator.num_out_points, 3,
                     generator=torch.Generator().manual_seed(0))
    for kind in seen:
        def record(radius, nsample, xyz, new_xyz, impl="auto",
                   return_dists=False, select_smallest=0, kind=kind):
            seen[kind][_ball_key(radius, nsample, xyz, new_xyz,
                                 select_smallest)] += 1
            return real(radius, nsample, xyz, new_xyz, impl=impl,
                        return_dists=return_dists,
                        select_smallest=select_smallest)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(losses, "query_ball_point", record)
            if kind == "cd":
                state = create_generator_state(cfg.generator, device="cpu")
                make_train_step(cfg, device="cpu")(
                    state, gt, torch.ones(2),
                    torch.Generator().manual_seed(0))
            else:
                state = create_gan_state(cfg, device="cpu")
                make_gan_train_step(cfg, device="cpu")(
                    state, gt, torch.ones(2),
                    torch.Generator().manual_seed(0))
    return seen, full.train.batch_size


@pytest.mark.parametrize("kind", ["cd", "gan"])
def test_ball_cases_are_the_steps_ball_queries(step_ball_calls, kind):
    seen, batch = step_ball_calls
    want = collections.Counter()
    for case in BALL_CASES:
        per = case.per_cd_step if kind == "cd" else case.per_gan_step
        if per:
            want[(case.n, case.m, case.c, case.radius, case.nsample,
                  case.select)] += per
        assert case.b == batch
    assert seen[kind] == want


def test_critic_ball_case_is_the_critics_widest_ball_grouping():
    """``DiscriminatorConfig(knn=False)`` groups by balls around n/8 seeds
    at three scales; the case is its widest, with a selection added to
    exercise every output mode."""
    from dispu_tpu_torch.config import DiscriminatorConfig
    from dispu_tpu_torch.models import discriminator

    seen = collections.Counter()
    real = discriminator.query_ball_point

    def record(radius, nsample, xyz, new_xyz, impl="auto"):
        seen[_ball_key(radius, nsample, xyz, new_xyz)] += 1
        return real(radius, nsample, xyz, new_xyz, impl=impl)

    cloud = torch.randn(2, 1024, 3, generator=torch.Generator().manual_seed(1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(discriminator, "query_ball_point", record)
        discriminator.paired_neighborhoods(DiscriminatorConfig(knn=False),
                                           cloud, cloud, impl="torch")
    case = next(c for c in BALL_CASES if c.label == "critic ball")
    assert seen[(case.n, case.m, case.c, case.radius, case.nsample, 0)] == 2
    assert case.nsample == max(key[4] for key in seen)


def test_ball_inputs_follow_their_cases():
    for case in BALL_CASES[:3]:
        pts, qs = ball_inputs(torch.Generator().manual_seed(4), case)
        again, _ = ball_inputs(torch.Generator().manual_seed(4), case)
        assert pts.shape == (case.b, case.n, case.c)
        assert qs.shape == (case.b, case.m, case.c)
        assert torch.equal(pts, again)
        assert torch.equal(qs, pts[:, ::case.n // case.m][:, :case.m])
        assert torch.equal(pts[:, -50:], pts[:, 100:150])  # tied points
