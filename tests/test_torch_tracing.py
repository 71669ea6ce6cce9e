"""The tracer (``dispu_tpu_torch/utils/tracing.py``): spans that record
only while a profiler records or inside ``recording()``, as the
profiler's ``cpu_op`` events, one stack a thread; the stage spans of a 4×
request and a CD step; no span in an exported program; the sync counter.

The counter's tests against the card's own waits are marked ``cuda`` and
skip without a card.  This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_tracing.py -q
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dispu_tpu_torch.config import (DataConfig, ExperimentConfig,
                                    GeneratorConfig, InferenceConfig,
                                    TrainConfig)
from dispu_tpu_torch.utils import tracing

SMALL = GeneratorConfig(num_points=64, knn=8, refine_nsample=8)
INF = dict(final_ratio=4, patch_num_point=64, patch_batch=4)
SERVE_4X = ["serve.request", "serve.prepare", "serve.generate", "serve.pass",
            "gen.extract", "gen.expand", "gen.refine", "serve.merge"]
CD_STEP = ["train.step", "train.draw", "train.forward", "gen.extract",
           "gen.expand", "gen.refine", "train.losses", "train.backward",
           "train.update"]


@pytest.fixture(autouse=True)
def _clean():
    tracing.clear()
    yield
    tracing.clear()


def _nest():
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass


def test_spans_are_off_by_default():
    a, b = tracing.span("a"), tracing.span("b")
    assert a is b  # the shared null context
    _nest()
    assert tracing.records() == []


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_spans_nest_and_record_when_on(how):
    if how == "recording":
        with tracing.recording():
            _nest()
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            _nest()
    outer, inner = tracing.records()
    assert (outer.name, outer.parent) == ("outer", None)
    assert (inner.name, inner.parent) == ("inner", "outer")
    assert outer.thread == inner.thread == threading.get_ident()
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    _nest()  # off again
    assert len(tracing.records()) == 2
    tracing.clear()
    assert tracing.records() == []


def test_spans_are_cpu_ops_of_the_profiler(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nest()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {e["name"]: e.get("cat") for e in
            json.loads(path.read_text())["traceEvents"]
            if e.get("name") in ("outer", "inner")}
    assert cats == {"outer": "cpu_op", "inner": "cpu_op"}


def test_each_thread_has_its_own_stack():
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(10)
        with tracing.span("other"):
            pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with tracing.recording(), tracing.span("main"):
        opened.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    by_name = {r.name: r for r in tracing.records()}
    assert by_name["other"].parent is None
    assert by_name["other"].thread != by_name["main"].thread
    main = by_name["main"]
    assert main.t0_ns <= by_name["other"].t0_ns <= main.t1_ns


def test_request_spans():
    from dispu_tpu_torch.inference import PatchUpsampler

    up = PatchUpsampler(None, SMALL, InferenceConfig(**INF), device="cpu")
    cloud = np.random.RandomState(0).randn(64, 3).astype(np.float32)
    with tracing.recording():
        out = up.upsample(cloud)
    assert out.shape == (256, 3)
    records = tracing.records()
    assert [r.name for r in records] == SERVE_4X
    parents = {r.name: r.parent for r in records}
    assert parents["serve.request"] is None
    assert parents["serve.pass"] == "serve.generate"
    assert parents["gen.extract"] == "serve.pass"


def test_cd_step_spans():
    from dispu_tpu_torch.train.state import create_generator_state
    from dispu_tpu_torch.train.steps import make_train_step

    cfg = ExperimentConfig(generator=SMALL, data=DataConfig(num_point=64),
                           train=TrainConfig(batch_size=2))
    state = create_generator_state(SMALL, device="cpu")
    step = make_train_step(cfg, device="cpu")
    gt = torch.rand(2, 256, 3, generator=torch.Generator().manual_seed(0))
    with tracing.recording():
        step(state, gt, torch.ones(2), torch.Generator().manual_seed(1))
    records = tracing.records()
    assert [r.name for r in records] == CD_STEP
    assert all(r.parent == "train.step" for r in records
               if r.name.startswith("train.") and r.name != "train.step")


def test_export_holds_no_span():
    from dispu_tpu_torch.inference import PatchUpsampler
    from dispu_tpu_torch.serving import _Entry

    up = PatchUpsampler(None, SMALL, InferenceConfig(**INF), device="cpu")
    with torch.no_grad():
        program = torch.export.export(_Entry(up), (torch.zeros(64, 3),))
    assert tracing.records() == []
    targets = [str(n.target) for n in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record" in t]


def test_counter_counts_sync_warnings_and_hides_them():
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        with tracing.recording(), tracing.span("outer"):
            with tracing.span("inner"):
                for _ in range(3):  # one line: "always", not once
                    warnings.warn(tracing.SYNC_MESSAGE, UserWarning)
                tracing.add_syncs(2)
            warnings.warn("another warning", UserWarning)
    outer, inner = tracing.records()
    assert (inner.syncs, outer.syncs) == (5, 5)  # the parent's include
    assert [str(w.message) for w in shown] == ["another warning"]
    tracing.add_syncs(1)  # no span open: nothing to count against
    assert [r.syncs for r in tracing.records()] == [5, 5]


# ------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_counter_counts_one_item_as_one(card):
    x = torch.ones((), device=card)
    x.item()
    with tracing.recording(), tracing.span("item"):
        x.item()
    assert tracing.records()[-1].syncs == 1
    assert torch.cuda.get_sync_debug_mode() == 0  # restored


@pytest.mark.cuda
def test_counter_counts_unique_as_the_profiler_does(card):
    from dispu_tpu_torch.kernels.knn import duplicate_rows_torch
    from dispu_tpu_torch.time_tracing import is_sync_call

    pts = torch.randn(32, 256, 24, device=card)
    pts[:, 200:] = pts[:, :56]
    duplicate_rows_torch(pts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tracing.span("dup"):
            duplicate_rows_torch(pts)
    events = list(prof.events())
    (span,) = [e for e in events if e.name == "dup"]
    calls = [e for e in events if is_sync_call(e.name)
             and span.time_range.start <= e.time_range.start
             < span.time_range.end]
    assert tracing.records()[-1].syncs == len(calls) > 0
